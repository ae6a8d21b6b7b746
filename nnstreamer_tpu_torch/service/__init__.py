"""nnstreamer_tpu_torch.service — the service control plane (L7).

Reference analog: the ML-Service C API (the reference ships it in a
sibling repo; SURVEY §1 L6) — pipelines registered by NAME, launched as
managed services, kept alive independently of any caller. This package
is that layer over the in-process runtime + the PR-1 serving dataplane,
with the two things the paper's managed-service story needs as
first-class features instead of caller responsibilities:

* **lifecycle supervision** — REGISTERED → STARTING → READY → DEGRADED →
  DRAINING → STOPPED, restart policies with exponential backoff + jitter,
  a max-restarts circuit breaker, crash postmortems, a stall watchdog,
  and k8s-style liveness/readiness probes;
* **zero-downtime model rollout** — versioned model slots referenced
  from launch lines as ``registry://<slot>``, hot-swapped live via
  prepare → warmup → atomic flip → retire (rollback on warmup failure),
  plus fractional canary routing between two versions;
* **a distributed replica fabric** (:mod:`.fabric`) — N service
  replicas behind one logical name with consistent-hash + bounded-load
  routing, retries/hedging under one propagated deadline, health-scored
  eviction → quarantine → probed readmission, and rolling hot swap +
  canary ACROSS replicas (docs/fabric.md).

Quick start::

    from nnstreamer_tpu_torch.service import ServiceManager, RestartPolicy

    mgr = ServiceManager()
    mgr.models.define("clf", {"1": "builtin://scaler?factor=2"}, active="1")
    svc = mgr.register(
        "edge-clf",
        "tensor_src num-buffers=-1 framerate=100 dimensions=4 "
        "! tensor_filter framework=torch model=registry://clf "
        "! tensor_sink name=out",
        restart=RestartPolicy(mode="always"), watchdog_s=5.0)
    svc.start()                    # blocks until READY (warmup done)
    mgr.models.add_version("clf", "2", "builtin://scaler?factor=3")
    mgr.models.swap("clf", "2")    # hot flip, zero downtime
    svc.drain()                    # graceful EOS shutdown

HTTP endpoint + CLI: ``python -m nnstreamer_tpu_torch serve`` /
``python -m nnstreamer_tpu_torch service <verb>`` (see :mod:`.api` and
docs/service.md).
"""
from .api import ControlClient, ControlServer  # noqa: F401
from .autoscaler import Autoscaler, AutoscalerConfig  # noqa: F401
from .fabric import (  # noqa: F401
    FabricError,
    NoReplicaAvailable,
    Replica,
    ReplicaPool,
    ReplicaState,
    RequestFailed,
    ServiceFabric,
)
from .health import HealthMonitor, service_snapshot  # noqa: F401
from .manager import (  # noqa: F401
    AdmissionRejected,
    Service,
    ServiceError,
    ServiceManager,
    ServiceSpec,
    ServiceState,
)
from .models import ModelSlots, QualityGateError, SwapError  # noqa: F401
from .procreplica import (  # noqa: F401
    ProcReplica,
    ProcReplicaError,
    ProcReplicaSet,
)
from .supervisor import CrashReport, RestartPolicy, Supervisor  # noqa: F401

__all__ = [
    "AdmissionRejected",
    "Autoscaler",
    "AutoscalerConfig",
    "ControlClient",
    "ControlServer",
    "CrashReport",
    "FabricError",
    "HealthMonitor",
    "ModelSlots",
    "NoReplicaAvailable",
    "ProcReplica",
    "ProcReplicaError",
    "ProcReplicaSet",
    "QualityGateError",
    "Replica",
    "ReplicaPool",
    "ReplicaState",
    "RequestFailed",
    "RestartPolicy",
    "Service",
    "ServiceError",
    "ServiceFabric",
    "ServiceManager",
    "ServiceSpec",
    "ServiceState",
    "Supervisor",
    "SwapError",
    "service_snapshot",
]
