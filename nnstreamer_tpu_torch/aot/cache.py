"""Persistent compile-artifact cache (L4').

The counterpart of nnstreamer_tpu's ``aot/cache.py``, the storage half of
the AOT plane: saved stage programs (:mod:`.export`) keyed the way
:class:`~..obs.profile.ProfileArtifact` keys profiles — **(topology hash,
caps, model version)** — extended with the **device signature** (the
card's name and compute capability, the visible count, the torch and
CUDA versions; ``cpu`` without a card) and the torch version, because a
saved program holds its weights on the device it was exported on. Each
artifact also carries a **stage id** (the canonical ``head..tail``
segment key the placement planner uses) and a **config digest** over
every member element's live configuration — transform options, filter
properties, and the RESOLVED model each member's backend serves (a
``registry://slot`` reference resolves through the live backend, so a
hot swap or a canary promote lands on a NEW digest and the old
version's artifact is never served stale).

Layout: ``<root>/aot-<topology>-<ctx>-<stage>.pt2`` (the bytes of
``torch.export.save``) + a ``.meta.json`` sidecar (key, stage, poly
flag, recorded inputs and outputs, batch range, blob sha256). Loads
verify the sha and evict a corrupt or truncated artifact — a damaged
cache degrades to a re-export, never a crash.

``<root>/xla/`` is where the reference attaches XLA's persistent
compilation cache. The port has no XLA; what it builds at a cold start
besides the trace is the hand kernels' libraries (``ops/build.py``,
``nvcc``), so :func:`attach_xla_cache` points ``ops/build.py`` at
``<root>/xla/``: a checkout with an empty ``build/`` takes the libraries
from there instead of running ``nvcc``, and new builds land there too.

GC mirrors ``ProfileStore``: ``NNS_AOT_CACHE_MAX`` bounds the artifact
count, ``save()`` LRU-prunes by mtime, ``python -m nnstreamer_tpu_torch
aot prune N`` prunes on demand. A ``base`` LM artifact would carry its
~0.75 GB of f32 weights, so the bound matters.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from ..analysis import sanitizer as _san
from ..obs import metrics as obs_metrics
from ..utils.log import logger
from .export import LoadedArtifact, load_artifact

SCHEMA_VERSION = 1
_EXT = ".pt2"

#: env var naming the on-disk compile cache directory; unset = AOT plane
#: off (every hook is a None check)
CACHE_ENV = "NNS_AOT_CACHE"

#: env var bounding the cache's artifact count (LRU prune on save);
#: unset/0 = unbounded
CACHE_MAX_ENV = "NNS_AOT_CACHE_MAX"

HITS = obs_metrics.counter(
    "nns_aot_cache_hits_total",
    "AOT compile-cache loads that served a saved artifact")
MISSES = obs_metrics.counter(
    "nns_aot_cache_misses_total",
    "AOT compile-cache lookups that found no usable artifact")
EXPORTS = obs_metrics.counter(
    "nns_aot_cache_exports_total",
    "stage programs exported and saved into the AOT compile cache")
EVICTIONS = obs_metrics.counter(
    "nns_aot_cache_evictions_total",
    "AOT artifacts removed (model swap, corruption, LRU prune)")
ARTIFACT_BYTES = obs_metrics.gauge(
    "nns_aot_artifact_bytes",
    "total saved artifact bytes in the active AOT cache")

STATS = {"hits": 0, "misses": 0, "exports": 0, "evictions": 0}


def _collect_aot(_registry) -> None:
    """Scrape-time collector: the artifact-bytes gauge from the active
    cache's disk footprint (0 with no cache configured)."""
    cache = default_cache()
    ARTIFACT_BYTES.set(float(cache.total_bytes()) if cache else 0.0)


obs_metrics.register_collector("aot", _collect_aot)


def device_signature() -> str:
    """The device half of the key: ``cpu`` without a card; else the
    card's name, compute capability and visible count, and the torch and
    CUDA versions — a program saved for one card generation (or one
    build) is not served on another."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    major, minor = torch.cuda.get_device_capability(0)
    return (f"cuda:{torch.cuda.get_device_name(0)}:sm{major}{minor}:"
            f"{torch.cuda.device_count()}:torch{torch.__version__}:"
            f"cuda{torch.version.cuda}")


def _torch_version() -> str:
    import torch

    return torch.__version__


def _model_fingerprint(model: str) -> str:
    """A model URI plus, for on-disk files, mtime+size — so retraining a
    file in place (same path, new weights) changes the digest."""
    try:
        st = os.stat(model)
        return f"{model}:{st.st_mtime_ns}:{st.st_size}"
    except OSError:
        return model


def element_config_digest(elements) -> str:
    """Digest over every member's live configuration: element type,
    canonical name, properties, and — for filter members — the model the
    opened backend ACTUALLY serves (``backend.props.model`` is the
    resolved URI, so ``registry://`` indirection, hot swaps and
    un-activated canaries all land on their true version)."""
    from ..obs import profile as obs_profile

    items: List[str] = []
    for el in elements:
        items.append(f"{obs_profile.canonical_base(el)}="
                     f"{el.ELEMENT_NAME or type(el).__name__}")
        props = getattr(el, "props", None)
        if props:
            try:
                prop_items = sorted(props.items())
            except Exception:  # noqa: BLE001 - prop mapping variants
                prop_items = []
            for k, v in prop_items:
                items.append(f"  {k}={v!r}")
        backend = getattr(el, "backend", None)
        bprops = getattr(backend, "props", None)
        if bprops is not None and getattr(bprops, "model", None):
            items.append(f"  @model={_model_fingerprint(bprops.model)}")
            custom = getattr(bprops, "custom", "") or ""
            if custom:
                items.append(f"  @custom={custom}")
    return hashlib.sha256("\n".join(items).encode()).hexdigest()[:16]


def pipeline_key(pipeline, model_version: str = "") -> dict:
    """The artifact key for one pipeline: the ProfileArtifact triple
    (topology hash, negotiated caps, model version) + device signature +
    torch version."""
    from ..obs import profile as obs_profile

    return {
        "topology": obs_profile.topology_hash(pipeline),
        "caps": obs_profile._negotiated_caps(pipeline),
        "model_version": str(model_version),
        "device": device_signature(),
        "torch": _torch_version(),
    }


def segment_identity(elements) -> Tuple[str, str]:
    """(stage id, config digest) for a run of elements — the stage id is
    the placement planner's canonical ``head..tail`` key, so placement
    plans can reference artifacts by the same name."""
    from ..obs import profile as obs_profile

    head = obs_profile.canonical_base(elements[0])
    stage = head if len(elements) == 1 else \
        f"{head}..{obs_profile.canonical_base(elements[-1])}"
    return stage, element_config_digest(elements)


def backend_key(backend, in_shapes) -> Tuple[dict, str, str]:
    """(key, stage, digest) for a singleton filter backend outside any
    pipeline context (the torch backend's invoke path): the 'topology'
    is the literal ``filter``, caps are the trailing-dim input signature
    (batch-free — the artifact is shape-poly), and the digest covers the
    resolved model + custom knobs + the backend's device."""
    props = getattr(backend, "props", None)
    model = getattr(props, "model", "") or ""
    custom = getattr(props, "custom", "") or ""
    sig = ";".join(
        f"{'x'.join(str(d) for d in tuple(s[0])[1:])}:{s[1]}"
        for s in in_shapes)
    digest = hashlib.sha256(
        f"{_model_fingerprint(model)}\n{custom}\n"
        f"{getattr(backend, 'device', None)}".encode()).hexdigest()[:16]
    key = {"topology": "filter", "caps": sig, "model_version": "",
           "device": device_signature(), "torch": _torch_version()}
    return key, "filter", digest


# -- the kernels' libraries ----------------------------------------------------

def attach_xla_cache(root: Optional[str] = None) -> bool:
    """Point the hand kernels' build (``ops/build.py``) at
    ``<root>/xla/`` — the place the reference gives XLA's persistent
    cache, here the ``nvcc`` output a cold start would otherwise
    rebuild. ``root`` defaults to ``NNS_AOT_CACHE``; returns False when
    the AOT plane is off."""
    root = root or os.environ.get(CACHE_ENV, "").strip()
    if not root:
        return False
    from ..ops import build

    build.attach_library_cache(os.path.join(os.path.abspath(root), "xla"))
    return True


# -- the store ---------------------------------------------------------------

class CompileCache:
    """On-disk store of exported stage programs, keyed by (topology,
    caps, model version, device signature, torch version) × (stage id,
    config digest). All writes are atomic (tmp + rename); all reads
    verify the meta's blob sha and evict on mismatch."""

    def __init__(self, root: str, max_artifacts: Optional[int] = None):
        self.root = root
        self.max_artifacts = max_artifacts
        os.makedirs(root, exist_ok=True)

    # -- naming --------------------------------------------------------------
    @staticmethod
    def _ctx_hash(key: dict) -> str:
        return hashlib.sha256(
            "\n".join(str(key.get(k, "")) for k in
                      ("caps", "model_version", "device", "torch"))
            .encode()).hexdigest()[:8]

    @staticmethod
    def _stage_hash(stage: str, digest: str) -> str:
        return hashlib.sha256(f"{stage}\n{digest}".encode()).hexdigest()[:8]

    def path_for(self, key: dict, stage: str, digest: str) -> str:
        return os.path.join(
            self.root,
            f"aot-{key.get('topology', 'unknown')}-{self._ctx_hash(key)}-"
            f"{self._stage_hash(stage, digest)}{_EXT}")

    @staticmethod
    def _meta_path(path: str) -> str:
        return path[:-len(_EXT)] + ".meta.json"

    # -- save/load -----------------------------------------------------------

    #: a writer crashed mid-save if its lockfile outlives this; break it
    _LOCK_STALE_S = 30.0

    def _acquire_save_lock(self, path: str) -> bool:
        """Per-key writer exclusion for the blob+meta replace pair: N
        cold replicas sharing one cache dir all miss and export the SAME
        key at once, and interleaved ``os.replace`` pairs would land
        blob_B under meta_A — which the next load sha-evicts. Losers
        skip the save (the winner's artifact is equivalent; the
        in-process fresh export still serves)."""
        lock = path + ".lock"
        flags = os.O_CREAT | os.O_EXCL | os.O_WRONLY
        try:
            os.close(os.open(lock, flags))
            if _san.LEAK:
                _san.note_acquire("aot_save_lock", lock)
            return True
        except FileExistsError:
            pass
        try:
            if time.time() - os.path.getmtime(lock) < self._LOCK_STALE_S:
                return False
            os.remove(lock)  # crashed writer: break the stale lock
            os.close(os.open(lock, flags))
            if _san.LEAK:
                _san.note_acquire("aot_save_lock", lock)
            return True
        except OSError:  # raced another breaker, or lock vanished
            return False

    def save(self, key: dict, stage: str, digest: str, blob: bytes,
             meta: dict) -> str:
        attach_xla_cache(self.root)
        path = self.path_for(key, stage, digest)
        if not self._acquire_save_lock(path):
            logger.info("aot cache: concurrent writer holds %s — "
                        "skipping save (equivalent artifact landing)", path)
            return path
        doc = {
            "schema": SCHEMA_VERSION,
            "kind": "nns-aot",
            "created": time.time(),
            "key": dict(key),
            "stage": stage,
            "config_digest": digest,
            "sha256": hashlib.sha256(blob).hexdigest(),
            **meta,
        }
        tmp = path + ".tmp"
        mtmp = self._meta_path(path) + ".tmp"
        try:
            with open(tmp, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, path)
            with open(mtmp, "w") as fh:
                json.dump(doc, fh, indent=2)
            os.replace(mtmp, self._meta_path(path))
        except BaseException:
            # a half-written temp must not stay on disk, and a published
            # blob without its meta is dead weight the next load evicts
            for stranded in (tmp, mtmp):
                try:
                    os.remove(stranded)
                except OSError:
                    pass
            raise
        finally:
            if _san.LEAK:
                _san.note_release("aot_save_lock", path + ".lock")
            try:
                os.remove(path + ".lock")
            except OSError:
                pass
        EXPORTS.inc()
        STATS["exports"] += 1
        if self.max_artifacts:
            self.prune(self.max_artifacts)
        return path

    def load(self, key: dict, stage: str, digest: str
             ) -> Optional[LoadedArtifact]:
        """The servable program for this key, or None (miss / corrupt —
        corrupt artifacts are evicted so the re-export can replace
        them)."""
        attach_xla_cache(self.root)
        path = self.path_for(key, stage, digest)
        meta = self._read_meta(path)
        if meta is None:
            MISSES.inc()
            STATS["misses"] += 1
            return None
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
            if hashlib.sha256(blob).hexdigest() != meta.get("sha256"):
                raise ValueError("artifact bytes do not match recorded sha")
            loaded = load_artifact(blob, poly=meta.get("poly"))
        except Exception as e:  # noqa: BLE001 - corrupt cache != crash
            logger.warning("aot cache: artifact %s unusable (%s) — "
                           "evicting, stage re-exports", path, e)
            self._remove(path)
            MISSES.inc()
            STATS["misses"] += 1
            return None
        # touch for LRU: served artifacts must outlive cold ones
        try:
            os.utime(path, None)
        except OSError:
            pass
        HITS.inc()
        STATS["hits"] += 1
        return loaded

    def meta_for(self, key: dict, stage: str, digest: str) -> Optional[dict]:
        return self._read_meta(self.path_for(key, stage, digest))

    def _read_meta(self, path: str) -> Optional[dict]:
        mpath = self._meta_path(path)
        if not os.path.exists(path) or not os.path.exists(mpath):
            return None
        try:
            with open(mpath) as fh:
                meta = json.load(fh)
            if meta.get("kind") != "nns-aot":
                raise ValueError("not an AOT artifact meta")
            if int(meta.get("schema", 0)) > SCHEMA_VERSION:
                raise ValueError(f"schema {meta['schema']} newer than "
                                 f"supported {SCHEMA_VERSION}")
            return meta
        except Exception as e:  # noqa: BLE001 - corrupt meta != crash
            logger.warning("aot cache: meta %s unreadable (%s) — evicting",
                           mpath, e)
            self._remove(path)
            return None

    # -- GC ------------------------------------------------------------------
    def _remove(self, path: str) -> None:
        removed = False
        for p in (path, self._meta_path(path)):
            try:
                os.remove(p)
                removed = True
            except OSError:
                continue
        if removed:
            EVICTIONS.inc()
            STATS["evictions"] += 1

    def evict(self, key: dict, stage: str, digest: str) -> bool:
        """Drop one artifact (the model-swap path: ``commit_model``
        retires the OLD version's program along with its backend).
        Returns whether a file was present."""
        path = self.path_for(key, stage, digest)
        existed = os.path.exists(path)
        self._remove(path)
        return existed

    def _artifact_paths(self) -> List[str]:
        return [os.path.join(self.root, f)
                for f in sorted(os.listdir(self.root))
                if f.startswith("aot-") and f.endswith(_EXT)]

    def prune(self, max_artifacts: Optional[int] = None) -> List[str]:
        """LRU-evict artifacts beyond the bound (oldest mtime first —
        ``load()`` touches its file). Returns removed paths."""
        bound = max_artifacts if max_artifacts is not None \
            else self.max_artifacts
        if not bound or bound < 1:
            return []
        paths = self._artifact_paths()
        if len(paths) <= bound:
            return []

        def mtime(p: str) -> float:
            try:
                return os.path.getmtime(p)
            except OSError:
                return 0.0
        victims = sorted(paths, key=lambda p: (mtime(p), p))[:-bound]
        for p in victims:
            self._remove(p)
        return victims

    # -- introspection -------------------------------------------------------
    def list(self) -> List[dict]:
        out = []
        for path in self._artifact_paths():
            meta = self._read_meta(path)
            if meta is None:
                continue
            out.append({"path": path, "stage": meta.get("stage", "?"),
                        "poly": bool(meta.get("poly")),
                        "nbytes": int(meta.get("nbytes", 0)),
                        **{k: meta.get("key", {}).get(k, "")
                           for k in ("topology", "caps", "model_version",
                                     "device")}})
        return out

    def metas(self, topology: Optional[str] = None) -> List[dict]:
        """Full meta docs, optionally of one topology — the replica
        warmup wants recorded inputs for ANY artifact covering the
        topology, not an exact config-digest match."""
        out = []
        for path in self._artifact_paths():
            meta = self._read_meta(path)
            if meta is None:
                continue
            if (topology is not None
                    and meta.get("key", {}).get("topology") != topology):
                continue
            out.append(meta)
        return out

    def stage_artifacts(self, topology: str) -> Dict[str, str]:
        """{stage id: artifact file basename} for every artifact of one
        topology — what a PlacementPlan embeds so a remote replica can
        fetch the exact programs its stages need."""
        out: Dict[str, str] = {}
        for entry in self.list():
            if entry.get("topology") == topology:
                out[entry["stage"]] = os.path.basename(entry["path"])
        return out

    def total_bytes(self) -> int:
        total = 0
        for p in self._artifact_paths():
            try:
                total += os.path.getsize(p)
            except OSError:
                continue
        return total


def default_cache() -> Optional["CompileCache"]:
    """The env-configured process cache (``NNS_AOT_CACHE`` dir), or None
    when the AOT plane is off."""
    root = os.environ.get(CACHE_ENV, "").strip()
    if not root:
        return None
    raw_max = os.environ.get(CACHE_MAX_ENV, "").strip()
    try:
        max_artifacts = int(raw_max) if raw_max else None
    except ValueError:
        max_artifacts = None
    return CompileCache(root, max_artifacts=max_artifacts)


def snapshot() -> dict:
    """JSON view for ``GET /profile``'s ``aot`` block and ``obs top``:
    counter totals + the active cache's inventory."""
    cache = default_cache()
    out = {
        "active": cache is not None,
        "counters": dict(STATS),
    }
    if cache is not None:
        entries = cache.list()
        out["root"] = cache.root
        out["artifacts"] = len(entries)
        # recorded nbytes, not a second dir walk (fleet-scraped)
        out["bytes"] = sum(e.get("nbytes", 0) for e in entries)
        out["poly"] = sum(1 for e in entries if e.get("poly"))
        out["entries"] = [
            {"stage": e["stage"], "topology": e["topology"],
             "poly": e["poly"], "nbytes": e["nbytes"]}
            for e in entries[:32]]
    return out


def render_section(snap: dict) -> List[str]:
    """The AOT block of the ``obs top`` dashboard."""
    lines = ["", "AOT COMPILE CACHE "
             + ("(off — set NNS_AOT_CACHE)" if not snap.get("active")
                else f"[{snap.get('root', '?')}]")]
    c = snap.get("counters", {})
    lines.append(
        f"  hits={c.get('hits', 0)} misses={c.get('misses', 0)} "
        f"exports={c.get('exports', 0)} evictions={c.get('evictions', 0)}")
    if snap.get("active"):
        lines.append(
            f"  artifacts={snap.get('artifacts', 0)} "
            f"(shape-poly {snap.get('poly', 0)}) "
            f"bytes={snap.get('bytes', 0)}")
        for e in snap.get("entries", []):
            lines.append(
                f"  {e['stage']:<40} topo={e['topology']:<18} "
                f"{'poly' if e['poly'] else 'static':<6} "
                f"{e['nbytes']:>9d}B")
    return lines


def reset_stats() -> None:
    """Zero the mirror counters (tests)."""
    for k in STATS:
        STATS[k] = 0
