"""Command-line tools::

    python -m nnstreamer_tpu_torch launch "tensor_src num-buffers=3 ... ! tensor_sink"
    python -m nnstreamer_tpu_torch inspect                # all elements
    python -m nnstreamer_tpu_torch inspect tensor_filter  # one element's props
    python -m nnstreamer_tpu_torch convert pipe.json      # description -> launch
    python -m nnstreamer_tpu_torch convert "a ! b"        # launch -> description
    python -m nnstreamer_tpu_torch codegen filter my_filter.py
    python -m nnstreamer_tpu_torch lint "a ! b"           # static pipeline lint
    python -m nnstreamer_tpu_torch lint                   # strict self-lint
    python -m nnstreamer_tpu_torch serve svc.json         # service control plane
    python -m nnstreamer_tpu_torch service list           # talk to a serve process
    python -m nnstreamer_tpu_torch replica --stage "..." --caps "..."
                                                          # one process replica
    python -m nnstreamer_tpu_torch obs metrics            # Prometheus scrape/dump
    python -m nnstreamer_tpu_torch obs flight             # crash flight recorder
    python -m nnstreamer_tpu_torch obs profile --launch "a ! b"  # profile artifact
    python -m nnstreamer_tpu_torch obs slo                # SLO burn-rate status
    python -m nnstreamer_tpu_torch obs top --watch --interval 2  # live dashboard
    python -m nnstreamer_tpu_torch obs quality            # tensor health / drift
    python -m nnstreamer_tpu_torch obs fleet              # fleet-merged planes
    python -m nnstreamer_tpu_torch obs flight --follow --fleet   # merged tail
    python -m nnstreamer_tpu_torch obs aot                # AOT cache snapshot
    python -m nnstreamer_tpu_torch aot export --launch "a ! b"  # export stages
    python -m nnstreamer_tpu_torch aot list|prune N       # compile-cache GC

The port of nnstreamer_tpu's ``__main__.py``: the same verbs, flags and
exit codes (``launch``: 0 at EOS, 1 on a bus ERROR, 2 on a timeout). A
launch line runs on ``cuda:0`` unless it asks for the CPU
(``accelerator=cpu`` on its filters); without a card such a line posts
the bus ERROR that names the missing device. The ``codegen`` filter
skeleton is a ``framework=torch`` model file.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional


def _cmd_launch(args) -> int:
    from .core import MessageType
    from .runtime.describe import load_pipeline_file
    from .runtime.parse import parse_launch

    import os

    place = None
    if args.place and os.environ.get("NNS_NO_PLACE", "") in ("1", "true",
                                                             "yes"):
        # the operational kill switch must win on BOTH input forms —
        # the file path below assigns pipe.place directly, bypassing
        # the Pipeline-constructor check the launch-string path gets
        args.place = None
    if args.place:
        if args.place == "auto":
            place = "auto"
        else:  # a saved PlacementPlan JSON
            from .runtime.placement import PlacementPlan

            with open(args.place) as fh:
                place = PlacementPlan.from_dict(json.load(fh))
    text = args.pipeline
    if text.endswith(".json") or text.endswith(".launch"):
        pipe = load_pipeline_file(text)
        if place is not None:
            pipe.place = place
    else:
        pipe = parse_launch(text, place=place)
    pipe.play()
    # no --timeout means "wait for the stream to finish" (bounded at a day
    # so a wedged pipeline still exits nonzero instead of hanging forever)
    timeout = args.timeout if args.timeout is not None else 86400.0
    msg = pipe.bus.wait_for((MessageType.EOS, MessageType.ERROR),
                            timeout=timeout)
    if args.latency:
        print(json.dumps(pipe.query_latency()))
    pipe.stop()
    if msg is None:
        print("timeout waiting for EOS", file=sys.stderr)
        return 2
    if msg.type is MessageType.ERROR:
        print(f"ERROR from {msg.source}: {msg.data}", file=sys.stderr)
        return 1
    print("pipeline finished (EOS)")
    return 0


def _cmd_inspect(args) -> int:
    from .registry.elements import element_factories, get_factory

    if not args.element:
        for name in element_factories():
            print(name)
        return 0
    cls = get_factory(args.element)
    print(f"{args.element}  ({cls.__module__}.{cls.__name__})")
    doc = (cls.__doc__ or "").strip().splitlines()
    if doc:
        print(f"  {doc[0]}")
    print("  pads:")
    for t in cls.SINK_TEMPLATES:
        print(f"    sink  {t.name_template}: {t.caps}")
    for t in cls.SRC_TEMPLATES:
        print(f"    src   {t.name_template}: {t.caps}")
    from .registry.elements import merged_properties

    merged = merged_properties(cls)
    if merged:
        print("  properties:")
        for k, p in merged.items():
            detail = f" — {p.doc}" if getattr(p, "doc", None) else ""
            print(f"    {k.replace('_', '-')}: default={p.default!r}{detail}")
    return 0


def _cmd_convert(args) -> int:
    from .runtime.describe import description_to_launch, launch_to_description

    text = args.input
    if getattr(args, "pbtxt", False) or getattr(args, "from_pbtxt", False):
        # reference tools/development/parser analog: topology <-> pbtxt
        from .runtime.parse import parse_launch
        from .runtime.pbtxt import from_pbtxt, to_pbtxt

        if getattr(args, "from_pbtxt", False):
            if text.endswith(".pbtxt"):
                with open(text) as fh:
                    text = fh.read()
            print(from_pbtxt(text))
        else:
            if text.endswith(".launch"):
                with open(text) as fh:
                    text = fh.read().strip()
            print(to_pbtxt(parse_launch(text)), end="")
        return 0
    if text.endswith(".json"):
        with open(text) as fh:
            print(description_to_launch(json.load(fh)))
    elif text.lstrip().startswith("{"):
        print(description_to_launch(json.loads(text)))
    else:
        if text.endswith(".launch"):
            with open(text) as fh:
                text = fh.read().strip()
        print(json.dumps(launch_to_description(text), indent=2))
    return 0


_FILTER_SKELETON = '''"""Custom tensor_filter model (generated skeleton).

Use:  tensor_filter framework=torch model={path}
"""
# nnlint: skip-file — generated scaffold (TODO stubs, no lifecycle/hot-path
# contracts yet); delete this line once implemented so lint covers the file
import torch

# optional: declare static shapes so negotiation completes before data flows
# from nnstreamer_tpu_torch.core import TensorsInfo
# from nnstreamer_tpu_torch.core.tensors import TensorSpec
# IN_INFO = TensorsInfo.of(TensorSpec((1, 224, 224, 3), "float32"))
# OUT_INFO = TensorsInfo.of(TensorSpec((1, 1001), "float32"))


def model(*tensors):
    """Gets the input tensors on the filter's device (cuda:0 unless the
    filter sets accelerator=cpu), returns output tensor(s)."""
    x = tensors[0]
    return torch.clone(x)  # TODO: your computation
'''

_DECODER_SKELETON = '''"""Custom tensor_decoder (generated skeleton).

Use:  tensor_decoder mode=python3 option1={path}
"""
# nnlint: skip-file — generated scaffold (TODO stubs, no lifecycle/hot-path
# contracts yet); delete this line once implemented so lint covers the file
from nnstreamer_tpu_torch.core import Buffer, Caps


class Decoder:
    def init(self, options):
        """options[0] is your option2, etc."""

    def get_out_caps(self, in_info):
        return Caps.new("text/plain")

    def decode(self, buf, in_info):
        # TODO: turn buf.tensors into a media Buffer
        return buf
'''

_CONVERTER_SKELETON = '''"""Custom tensor_converter (generated skeleton).

Use:  tensor_converter subplugin=python3 subplugin-option={path}
"""
# nnlint: skip-file — generated scaffold (TODO stubs, no lifecycle/hot-path
# contracts yet); delete this line once implemented so lint covers the file
import numpy as np

from nnstreamer_tpu_torch.core import Buffer, TensorsInfo
from nnstreamer_tpu_torch.core.tensors import TensorSpec


class Converter:
    def get_out_info(self, in_caps):
        return TensorsInfo.of(TensorSpec((1,), "float32"))

    def convert(self, buf):
        raw = np.asarray(buf.tensors[0])
        # TODO: parse your media bytes into tensors
        return Buffer([raw.astype(np.float32)[:1]])
'''

_SKELETONS = {
    "filter": _FILTER_SKELETON,
    "decoder": _DECODER_SKELETON,
    "converter": _CONVERTER_SKELETON,
}


def _cmd_codegen(args) -> int:
    skel = _SKELETONS[args.kind]
    with open(args.output, "w") as fh:
        fh.write(skel.format(path=args.output))
    print(f"wrote {args.kind} skeleton to {args.output}")
    return 0


def _cmd_serve(args) -> int:
    """Run the service control plane: register services from a JSON config
    (and/or --service name=launch args), serve the HTTP control endpoint,
    supervise until interrupted. Config schema (all keys optional)::

        {"models": {"slot": {"versions": {"1": "uri"}, "active": "1"}},
         "services": [{"name": "...", "launch": "...",
                       "restart": "always" | {"mode": ..., ...},
                       "watchdog_s": 5.0, "autostart": true}]}
    """
    import time

    from .service import ControlServer, ServiceManager
    from .service.supervisor import RestartPolicy

    mgr = ServiceManager()
    cfg = {}
    if args.config:
        with open(args.config) as fh:
            cfg = json.load(fh)
    for slot, entry in (cfg.get("models") or {}).items():
        mgr.models.define(slot, entry["versions"], entry["active"])
    for sdef in cfg.get("services") or []:
        sdef = dict(sdef)
        restart = sdef.pop("restart", None)
        policy = (RestartPolicy.from_config(restart)
                  if restart is not None else None)
        mgr.register(sdef.pop("name"), sdef.pop("launch", None),
                     pbtxt=sdef.pop("pbtxt", None), restart=policy, **sdef)
    for spec in args.service or []:
        name, _, launch = spec.partition("=")
        if not launch:
            print(f"--service needs name=launch, got '{spec}'",
                  file=sys.stderr)
            return 2
        mgr.register(name, launch)
    server = ControlServer(mgr, host=args.host, port=args.port).start()
    print(f"service control endpoint: {server.endpoint}", flush=True)
    if args.start_all:
        for svc in mgr.services():
            svc.start(wait=False)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        print("shutting down services...", flush=True)
    finally:
        mgr.shutdown()
        server.stop()
    return 0


def _obs_profile(args) -> int:
    """``obs profile``: snapshot, artifact emission, merge, diff."""
    from .obs import profile as obs_profile
    from .service import ControlClient

    if args.merge:
        if not args.out:
            print("--merge needs --out PATH for the merged artifact",
                  file=sys.stderr)
            return 2
        arts = [obs_profile.ProfileArtifact.load(p) for p in args.merge]
        base = arts[0]
        for a in arts[1:]:
            base.merge(a)
        base.save(args.out)
        print(f"merged {len(arts)} artifact(s) -> {args.out}")
        print(json.dumps(base.summary(), indent=2))
        return 0
    if args.diff:
        a = obs_profile.ProfileArtifact.load(args.diff[0])
        b = obs_profile.ProfileArtifact.load(args.diff[1])
        print(json.dumps(a.diff(b), indent=2))
        return 0
    if args.launch:
        from .runtime.parse import parse_launch

        pipe = parse_launch(args.launch)
        obs_profile.start()
        if args.quality:
            # tensor health taps alongside the profiler: the emitted
            # artifact then carries a `quality` section usable as a
            # drift baseline (quality.set_baseline)
            from .obs import quality as obs_quality

            obs_quality.start()
        try:
            pipe.run(timeout=args.run_timeout)
        finally:
            obs_profile.stop()
            if args.quality:
                obs_quality.stop()
        art = obs_profile.ProfileArtifact.capture(
            pipe, model_version=args.model_version)
        out = args.out or "profile.json"
        art.save(out)
        print(f"wrote profile artifact {out} "
              f"(topology {art.key['topology']}, "
              f"model '{art.key['model_version']}')")
        print(json.dumps(art.summary(), indent=2))
        return 0
    if args.endpoint:
        print(json.dumps(ControlClient(args.endpoint).profile(), indent=2))
    else:
        print(json.dumps(obs_profile.snapshot(), indent=2))
    return 0


def _obs_store(args) -> int:
    """``obs store``: list the profile-artifact store, ``--prune N``
    LRU-evicts down to the newest N artifacts (the GC ``ProfileStore``
    applies automatically when ``NNS_PROFILE_STORE_MAX`` is set)."""
    import os

    from .obs import profile as obs_profile

    root = args.root or os.environ.get(obs_profile.STORE_ENV, "").strip()
    if not root:
        print("error: no store — pass --root DIR or set "
              f"{obs_profile.STORE_ENV}", file=sys.stderr)
        return 2
    if not os.path.isdir(root):
        # an inspection verb must not conjure the directory a typo names
        # (ProfileStore.__init__ creates its root for writers)
        print(f"error: store directory '{root}' does not exist",
              file=sys.stderr)
        return 2
    store = obs_profile.ProfileStore(root)
    if args.prune:
        removed = store.prune(args.prune)
        print(f"pruned {len(removed)} artifact(s) from {root} "
              f"(bound {args.prune})")
        for p in removed:
            print(f"  removed {p}")
    entries = store.list()
    print(f"{len(entries)} artifact(s) in {root}")
    for e in entries:
        print(f"  {e['path']}  topology={e.get('topology', '?')} "
              f"model='{e.get('model_version', '')}'")
    return 0


def _obs_top(args) -> int:
    """``obs top``: one-shot (default) or ``--watch`` refreshing text
    dashboard of per-element rates, queue waits/depths, fused quantiles,
    request series, MEMORY/QUALITY sections, and SLO burn.
    ``--interval N`` (seconds, default 2.0) sets the refresh cadence."""
    import time

    from .obs import profile as obs_profile
    from .service import ControlClient, ServiceError

    if args.interval <= 0:
        print(f"error: --interval must be > 0 seconds "
              f"(got {args.interval})", file=sys.stderr)
        return 2

    def fetch() -> dict:
        if args.endpoint:
            client = ControlClient(args.endpoint)
            data = client.profile()
            try:
                data["memory"] = client.memory().get("memory")
            except ServiceError:
                data["memory"] = None  # a serve process without the route
            try:
                data["quality"] = client.quality().get("quality")
            except ServiceError:
                data["quality"] = None  # a serve process without the route
            try:
                data["fleet"] = client.fleet().get("fleet")
            except ServiceError:
                data["fleet"] = None  # a serve process without the route
            try:
                data["transport"] = client.transport().get("transport")
            except ServiceError:
                data["transport"] = None  # a serve process without the route
            return data
        from . import aot
        from .obs import fleet as obs_fleet
        from .obs import memory as obs_memory
        from .obs import quality as obs_quality
        from .obs import slo as obs_slo
        from .runtime import placement
        from .service import autoscaler as svc_autoscaler
        from .transport import stats as wire_stats

        return {"profile": obs_profile.snapshot(),
                "slo": obs_slo.status_all(),
                "placement": placement.snapshot_all(),
                "memory": obs_memory.snapshot(),
                "quality": obs_quality.snapshot(),
                "autoscale": svc_autoscaler.snapshot_all(),
                "fleet": obs_fleet.snapshot_all(),
                "transport": wire_stats.snapshot(),
                "aot": aot.snapshot()}

    while True:
        data = fetch()
        print(obs_profile.render_top(data.get("profile", {}),
                                     data.get("slo", []),
                                     placement=data.get("placement"),
                                     memory=data.get("memory"),
                                     quality=data.get("quality"),
                                     autoscale=data.get("autoscale"),
                                     fleet=data.get("fleet"),
                                     transport=data.get("transport"),
                                     aot=data.get("aot")))
        if not args.watch:
            return 0
        try:
            time.sleep(args.interval)
        except KeyboardInterrupt:
            return 0
        print()


def _follow_flight(fetch, interval: float, max_polls: Optional[int] = None,
                   out=None) -> int:
    """The ``obs flight --follow`` tail loop: ``fetch(after)`` returns
    (events, new_cursor); each new event prints as one JSON line.
    ``max_polls`` bounds the loop (tests); None = until interrupted."""
    import time

    out = out if out is not None else sys.stdout
    cursor = None
    polls = 0
    while max_polls is None or polls < max_polls:
        if polls:
            try:
                time.sleep(interval)
            except KeyboardInterrupt:
                return 0
        polls += 1
        try:
            events, cursor = fetch(cursor)
        except KeyboardInterrupt:
            return 0
        for ev in events:
            print(json.dumps(ev, default=str), file=out, flush=True)
    return 0


def _obs_flight(args) -> int:
    """``obs flight``: one-shot dump, or ``--follow`` tail mode (poll
    with a seq cursor, print only NEW events as JSON lines). ``--fleet``
    follows the fleet-MERGED stream (replica-tagged, interleaved by
    timestamp) instead of one process's recorder."""
    from .service import ControlClient, ServiceError

    if args.interval <= 0:
        print(f"error: --interval must be > 0 seconds "
              f"(got {args.interval})", file=sys.stderr)
        return 2

    def fetch(cursor):
        # a CURSORED pull must not cap below the ring size: the cursor
        # still advances to the newest seq, so a burst bigger than
        # --last would otherwise be silently skipped by the tail.
        # --last only positions the FIRST poll (and one-shot dumps).
        last = args.last if cursor is None else 1_000_000
        if args.endpoint:
            client = ControlClient(args.endpoint)
            if args.fleet:
                doc = client.fleet_flight(
                    last=last, after=cursor,
                    category=args.category, pipeline=args.pipeline)
                events = doc["events"]
                key = "fleet_seq"
            else:
                events = client.flight(
                    last=last, pipeline=args.pipeline,
                    category=args.category, after=cursor)["events"]
                key = "seq"
        elif args.fleet:
            from .obs import fleet as obs_fleet

            v = obs_fleet.view()
            if v is None:
                raise ServiceError("no live fleet view in this process "
                                   "(use --endpoint against a serve "
                                   "process that runs one)")
            events = v.flight(last=last, after=cursor,
                              category=args.category,
                              pipeline=args.pipeline)
            key = "fleet_seq"
        else:
            from .obs import flight as obs_flight

            events = obs_flight.dump(last=last,
                                     pipeline=args.pipeline,
                                     category=args.category, after=cursor)
            key = "seq"
        if events:
            cursor = max(ev[key] for ev in events)
        return events, cursor

    if args.follow:
        return _follow_flight(fetch, args.interval)
    events, _cursor = fetch(None)
    print(json.dumps(events, indent=2, default=str))
    return 0


def _cmd_obs(args) -> int:
    """Observability verbs:

    * ``obs metrics`` — Prometheus text: scraped from a running serve
      endpoint (``--endpoint``) or rendered from THIS process's registry
      (useful under ``python -c``/tests; a fresh CLI process has no
      pipelines, so local mode mostly shows the obs plane itself);
    * ``obs flight`` — the crash flight recorder's recent events
      (``--pipeline`` filters on the event's pipeline tag; ``--follow``
      tails with a seq cursor, ``--fleet`` reads the fleet-merged
      replica-tagged stream);
    * ``obs fleet`` — fleet-view snapshots: per-replica scrape health
      plus the merged profile/memory/quality planes (obs/fleet.py),
      local or ``--endpoint``;
    * ``obs trace`` — export recorded spans as Perfetto/chrome-trace
      JSON (``--out``, default nns_spans.json);
    * ``obs profile`` — continuous-profiler snapshot (local or
      ``--endpoint``), or run ``--launch`` under the profiler and write
      a profile artifact (``--out``); ``--merge``/``--diff`` operate on
      saved artifacts;
    * ``obs slo`` — SLO status (burn rates, alerting) local or remote;
    * ``obs top`` — one-shot/``--watch`` text dashboard (incl. MEMORY +
      QUALITY; ``--interval`` sets the watch cadence);
    * ``obs memory`` — device-memory accounting snapshot (stage byte
      estimates, device watermarks, queue/serving bytes) local or
      ``--endpoint``;
    * ``obs quality`` — data-plane quality snapshot (per-edge tensor
      health, baseline stages, drift scores) local or ``--endpoint``;
    * ``obs store`` — list the profile-artifact store; ``--prune N``
      LRU-evicts old artifacts;
    * ``obs aot`` — the AOT compile cache's counters and inventory
      (``aot.snapshot()``), local or ``--endpoint``.
    """
    from .service import ControlClient, ServiceError

    try:
        if args.verb == "metrics":
            if args.endpoint:
                print(ControlClient(args.endpoint).metrics_text(), end="")
            else:
                from .obs import metrics as obs_metrics

                print(obs_metrics.render(), end="")
        elif args.verb == "flight":
            return _obs_flight(args)
        elif args.verb == "fleet":
            if args.endpoint:
                snaps = ControlClient(args.endpoint).fleet()["fleet"]
            else:
                from .obs import fleet as obs_fleet

                snaps = obs_fleet.snapshot_all()
            print(json.dumps(snaps, indent=2, default=str))
        elif args.verb == "memory":
            if args.endpoint:
                snap = ControlClient(args.endpoint).memory()["memory"]
            else:
                from .obs import memory as obs_memory

                snap = obs_memory.snapshot()
            print(json.dumps(snap, indent=2, default=str))
        elif args.verb == "quality":
            if args.endpoint:
                snap = ControlClient(args.endpoint).quality()["quality"]
            else:
                from .obs import quality as obs_quality

                snap = obs_quality.snapshot()
            print(json.dumps(snap, indent=2, default=str))
        elif args.verb == "store":
            return _obs_store(args)
        elif args.verb == "aot":
            if args.endpoint:
                snap = ControlClient(args.endpoint).profile().get("aot")
            else:
                from . import aot

                snap = aot.snapshot()
            print(json.dumps(snap, indent=2, default=str))
        elif args.verb == "profile":
            return _obs_profile(args)
        elif args.verb == "slo":
            if args.endpoint:
                status = ControlClient(args.endpoint).profile()["slo"]
            else:
                from .obs import slo as obs_slo

                status = obs_slo.status_all()
            print(json.dumps(status, indent=2, default=str))
        elif args.verb == "top":
            return _obs_top(args)
        elif args.verb == "trace":
            if args.endpoint:
                # no remote span-export route exists; silently exporting
                # THIS fresh process's empty ring would read as "the
                # server recorded nothing"
                print("error: 'obs trace' exports this process's spans "
                      "only — --endpoint is not supported (use "
                      "obs.export_chrome_trace() in the serve process)",
                      file=sys.stderr)
                return 2
            from .obs import context as obs_context

            path = args.out or "nns_spans.json"
            doc = obs_context.export_chrome_trace(path)
            print(f"wrote {len(doc['traceEvents'])} span(s) to {path}")
        else:
            print(f"unknown verb '{args.verb}'", file=sys.stderr)
            return 2
    except ServiceError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0


def _cmd_aot(args) -> int:
    """``aot`` verbs:

    * ``aot export --launch "a ! b"`` — run the launch line with the
      compile cache active so every fused segment / singleton filter
      exports its artifact; restarts, hot-swap prepares and replica
      spawns of the same topology then load instead of tracing;
    * ``aot list`` — the cache inventory (stage, topology, poly flag,
      bytes, device);
    * ``aot prune N`` — LRU-evict down to the newest N artifacts (the
      GC ``NNS_AOT_CACHE_MAX`` applies on every save).
    """
    import os

    from . import aot

    root = args.root or os.environ.get(aot.CACHE_ENV, "").strip()
    if not root:
        print(f"error: no cache — pass --root DIR or set {aot.CACHE_ENV}",
              file=sys.stderr)
        return 2
    if args.verb == "export":
        if not args.launch:
            print("error: aot export needs --launch 'a ! b'",
                  file=sys.stderr)
            return 2
        from .obs import profile as obs_profile
        from .runtime.parse import parse_launch

        # the cache hooks read the env; an explicit --root must win for
        # this run AND for any subprocess the pipeline spawns
        os.environ[aot.CACHE_ENV] = root
        cache = aot.default_cache()
        before = {e["path"] for e in cache.list()}
        pipe = parse_launch(args.launch)
        pipe.run(timeout=args.run_timeout)
        topo = obs_profile.topology_hash(pipe)
        entries = cache.list()
        fresh = {e["path"] for e in entries if e["path"] not in before}
        print(f"topology {topo}: {len(fresh)} artifact(s) exported, "
              f"{len(entries)} total in {root}")
        for e in entries:
            print(f" {'+' if e['path'] in fresh else ' '} {e['stage']}  "
                  f"{'poly' if e['poly'] else 'static'}  "
                  f"{e['nbytes']}B  topology={e['topology']}")
        return 0
    cache = aot.CompileCache(root)
    if args.verb == "prune":
        if not args.count or args.count < 1:
            print("error: aot prune needs a positive COUNT",
                  file=sys.stderr)
            return 2
        removed = cache.prune(args.count)
        print(f"pruned {len(removed)} artifact(s) from {root} "
              f"(bound {args.count})")
        for p in removed:
            print(f"  removed {p}")
    entries = cache.list()
    print(f"{len(entries)} artifact(s) in {root} "
          f"({cache.total_bytes()} bytes)")
    for e in entries:
        print(f"  {e['stage']}  {'poly' if e['poly'] else 'static'}  "
              f"{e['nbytes']}B  topology={e['topology']} "
              f"device={e['device']}")
    return 0


def _cmd_service(args) -> int:
    """CLI verbs against a running serve endpoint (start/stop/list/status/
    swap/drain and canary control)."""
    from .service import ControlClient, ServiceError

    c = ControlClient(args.endpoint)
    try:
        verb = args.verb
        if verb == "list":
            out = c.list()
        elif verb == "status":
            out = c.status(args.name)
        elif verb == "start":
            out = c.start(args.name)
        elif verb == "stop":
            out = c.stop(args.name)
        elif verb == "drain":
            out = c.drain(args.name, timeout_s=args.timeout)
        elif verb == "register":
            out = c.register(name=args.name, launch=args.launch)
        elif verb == "unregister":
            out = c.unregister(args.name)
        elif verb == "models":
            out = c.models()
        elif verb == "swap":
            out = c.swap(args.name, args.version)
        elif verb == "canary":
            out = c.canary(args.name, args.version, args.fraction,
                           quality_gate=True if args.quality_gate else None)
        else:  # promote (argparse holds the verb to its choices)
            out = c.promote(args.name)
    except ServiceError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2, default=str))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nnstreamer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("launch", help="run a pipeline (gst-launch analog)")
    p.add_argument("pipeline", help="launch text, .json, or .launch file")
    p.add_argument("--timeout", type=float, default=None)
    p.add_argument("--latency", action="store_true",
                   help="print the pipeline LATENCY query (JSON) at EOS")
    p.add_argument("--place", default=None, metavar="auto|PLAN.json",
                   help="profile-guided cross-device placement: 'auto' "
                        "plans from the NNS_PROFILE_STORE artifact store "
                        "(calibrating on a miss), a path applies a saved "
                        "PlacementPlan JSON")
    p.set_defaults(fn=_cmd_launch)

    p = sub.add_parser("inspect", help="list elements / show one (gst-inspect)")
    p.add_argument("element", nargs="?", default=None)
    p.set_defaults(fn=_cmd_inspect)

    p = sub.add_parser("convert", help="launch text <-> JSON description "
                                       "(or <-> pbtxt with --pbtxt)")
    p.add_argument("--pbtxt", action="store_true",
                   help="emit MediaPipe-style pbtxt (reference "
                        "tools/development/parser format)")
    p.add_argument("--from-pbtxt", action="store_true", dest="from_pbtxt",
                   help="rebuild a launch string from pbtxt topology")
    p.add_argument("input", help="launch string, JSON string, or file path")
    p.set_defaults(fn=_cmd_convert)

    p = sub.add_parser("codegen", help="generate subplugin skeletons")
    p.add_argument("kind", choices=sorted(_SKELETONS))
    p.add_argument("output", help="output .py path")
    p.set_defaults(fn=_cmd_codegen)

    p = sub.add_parser("serve", help="run the service control plane "
                                     "(supervised named services + HTTP "
                                     "endpoint)")
    p.add_argument("config", nargs="?", default=None,
                   help="JSON config with models/services (see serve docs)")
    p.add_argument("--service", action="append", metavar="NAME=LAUNCH",
                   help="register a service inline (repeatable)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="control endpoint port (0 = ephemeral, printed)")
    p.add_argument("--start-all", action="store_true",
                   help="start every registered service immediately")
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("replica", help="run ONE process-isolated query-"
                                       "server replica (spawned by "
                                       "ProcReplicaSet / the autoscaler)")
    from .service.procreplica import add_replica_args

    add_replica_args(p)

    p = sub.add_parser("service", help="control verbs against a running "
                                       "serve endpoint")
    p.add_argument("verb", choices=["list", "status", "start", "stop",
                                    "drain", "register", "unregister",
                                    "models", "swap", "canary", "promote"])
    p.add_argument("name", nargs="?", default=None,
                   help="service name (or model slot for swap/canary/"
                        "promote)")
    p.add_argument("version", nargs="?", default=None,
                   help="model version (swap/canary)")
    p.add_argument("--endpoint", default="http://127.0.0.1:8639",
                   help="control endpoint URL")
    p.add_argument("--launch", default=None, help="launch line (register)")
    p.add_argument("--fraction", type=float, default=0.1,
                   help="canary traffic fraction")
    p.add_argument("--quality-gate", action="store_true",
                   dest="quality_gate",
                   help="canary: arm the output-quality promotion gate "
                        "(mirrored shadow traffic + divergence check; "
                        "promote refuses with QualityGateError on "
                        "divergence)")
    p.add_argument("--timeout", type=float, default=30.0,
                   help="drain timeout seconds")
    p.set_defaults(fn=_cmd_service)

    p = sub.add_parser("obs", help="observability: /metrics scrape, "
                                   "flight-recorder dump, span export, "
                                   "profiler/SLO/top, memory accounting, "
                                   "tensor quality/drift, "
                                   "artifact-store GC, the AOT cache")
    p.add_argument("verb", choices=["metrics", "flight", "trace",
                                    "profile", "slo", "top", "memory",
                                    "quality", "store", "fleet", "aot"])
    p.add_argument("--endpoint", default=None,
                   help="serve control endpoint URL (omit = this process)")
    p.add_argument("--last", type=int, default=64,
                   help="flight: newest N events")
    p.add_argument("--pipeline", default=None,
                   help="flight: only events tagged with this pipeline")
    p.add_argument("--category", default=None,
                   help="flight: only events of this kind (memory, slo, "
                        "pipeline, serving, ...)")
    p.add_argument("--follow", action="store_true",
                   help="flight: tail mode — poll with a seq cursor and "
                        "print only NEW events (JSON lines) until "
                        "interrupted")
    p.add_argument("--fleet", action="store_true",
                   help="flight: read the fleet-MERGED event stream "
                        "(replica-tagged, timestamp-interleaved — "
                        "obs/fleet.py) instead of one process's recorder")
    p.add_argument("--root", default=None,
                   help="store: artifact directory (default "
                        "NNS_PROFILE_STORE)")
    p.add_argument("--prune", type=int, default=0, metavar="N",
                   help="store: LRU-evict down to the newest N artifacts")
    p.add_argument("--out", default=None,
                   help="trace/profile: output JSON path")
    p.add_argument("--launch", default=None,
                   help="profile: run this launch line under the profiler "
                        "and write a profile artifact")
    p.add_argument("--model-version", default="",
                   help="profile: model version recorded in the artifact "
                        "key")
    p.add_argument("--quality", action="store_true",
                   help="profile: also run the tensor health taps during "
                        "--launch, so the artifact carries a quality "
                        "section (a drift baseline)")
    p.add_argument("--run-timeout", type=float, default=300.0,
                   help="profile: --launch run timeout seconds")
    p.add_argument("--merge", nargs="+", metavar="ARTIFACT",
                   help="profile: merge saved artifacts into --out")
    p.add_argument("--diff", nargs=2, metavar=("A", "B"),
                   help="profile: p50/p99 deltas between two artifacts")
    p.add_argument("--watch", action="store_true",
                   help="top: keep refreshing until interrupted")
    p.add_argument("--interval", type=float, default=2.0, metavar="SECONDS",
                   help="top: --watch refresh interval in seconds "
                        "(default 2.0, must be > 0)")
    p.set_defaults(fn=_cmd_obs)

    p = sub.add_parser("aot", help="AOT compile-artifact cache: export "
                                   "stage programs, list/prune the store")
    p.add_argument("verb", choices=["export", "list", "prune"])
    p.add_argument("count", nargs="?", type=int, default=0,
                   help="prune: keep the newest COUNT artifacts")
    p.add_argument("--root", default=None,
                   help="cache directory (default NNS_AOT_CACHE)")
    p.add_argument("--launch", default=None,
                   help="export: run this launch line with the cache "
                        "active so its stages export artifacts")
    p.add_argument("--run-timeout", type=float, default=300.0,
                   help="export: --launch run timeout seconds")
    p.set_defaults(fn=_cmd_aot)

    p = sub.add_parser("lint", help="static pipeline-graph / source lint "
                                    "(no target: strict self-lint of "
                                    "this package)")
    from .analysis.cli import add_lint_args, run_lint

    add_lint_args(p)
    p.set_defaults(fn=run_lint)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
