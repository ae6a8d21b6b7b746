"""Command-line tools of the service plane::

    python -m nnstreamer_tpu_torch serve svc.json     # service control plane
    python -m nnstreamer_tpu_torch service list       # talk to a serve process
    python -m nnstreamer_tpu_torch replica --stage "..." --caps "..."
                                                      # one process replica
    python -m nnstreamer_tpu_torch obs fleet          # fleet-merged planes
    python -m nnstreamer_tpu_torch obs aot            # AOT cache snapshot
    python -m nnstreamer_tpu_torch aot export --launch "a ! b"  # export stages
    python -m nnstreamer_tpu_torch aot list|prune N   # compile-cache GC

The port of the same verbs of nnstreamer_tpu's ``__main__.py``. A launch
line runs on ``cuda:0`` unless it asks for the CPU (``accelerator=cpu`` on
its filters); without a card such a line posts the bus ERROR that names
the missing device, and its service does not become READY.
"""
from __future__ import annotations

import argparse
import json
import sys


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


def _cmd_obs(args) -> int:
    """``obs fleet``: fleet-view snapshots — per-replica scrape health
    plus the merged profile/memory/quality planes (obs/fleet.py), of this
    process or of a serve process at ``--endpoint``. ``obs aot``: the
    AOT compile cache's counters and inventory (``aot.snapshot()``), of
    this process or of the serve process's ``GET /profile``."""
    from .service import ControlClient, ServiceError

    try:
        if args.verb == "aot":
            if args.endpoint:
                snaps = ControlClient(args.endpoint).profile().get("aot")
            else:
                from . import aot

                snaps = aot.snapshot()
        elif args.endpoint:
            snaps = ControlClient(args.endpoint).fleet()["fleet"]
        else:
            from .obs import fleet as obs_fleet

            snaps = obs_fleet.snapshot_all()
    except ServiceError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(snaps, indent=2, default=str))
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

    p = sub.add_parser("obs", help="observability: the fleet view, the "
                                   "AOT cache")
    p.add_argument("verb", choices=["fleet", "aot"])
    p.add_argument("--endpoint", default=None,
                   help="serve control endpoint URL (omit = this process)")
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

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
