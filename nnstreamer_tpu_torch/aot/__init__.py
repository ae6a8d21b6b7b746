"""AOT artifact plane: a persistent cache of exported stage programs and
their shape-polymorphic ``torch.export`` (the counterpart of
nnstreamer_tpu's ``aot/``).

A supervised restart, a ``registry://`` hot-swap prepare and a fresh
subprocess replica each rebuild their stages: the Python trace of the
model, and on a clean checkout the hand kernels' ``nvcc`` builds. This
package makes a stage program a **serializable artifact**:

* :mod:`.export` traces a stage callable once through
  ``torch.export.export`` with a symbolic batch dim — ONE artifact
  covers every serving batch in its recorded range — and loads it back
  (the ``nns::`` kernel ops registered first);
* :mod:`.cache` persists the saved program keyed like a
  ``ProfileArtifact`` (topology, caps, model version) + device
  signature, LRU-bounded, with the kernels' libraries kept under the
  same root.

Consumers: ``runtime/fusion.py`` (fused segments load or export at their
first buffer), ``backends/torch_backend.py`` (singleton filters),
``backends/pt2_backend.py`` (``framework=torch-export``),
``service/procreplica.py`` (replicas warm through artifacts before
READY), ``runtime/placement.py`` (plans name artifacts). Everything is
off unless ``NNS_AOT_CACHE`` names a directory.
"""
from .cache import (
    CACHE_ENV,
    CACHE_MAX_ENV,
    STATS,
    CompileCache,
    attach_xla_cache,
    backend_key,
    default_cache,
    device_signature,
    element_config_digest,
    pipeline_key,
    render_section,
    reset_stats,
    segment_identity,
    snapshot,
)
from .export import (
    ExportError,
    LoadedArtifact,
    export_stage,
    fabricate_inputs,
    guarded,
    load_artifact,
)

__all__ = [
    "CACHE_ENV", "CACHE_MAX_ENV", "STATS", "CompileCache",
    "attach_xla_cache", "backend_key", "default_cache",
    "device_signature", "element_config_digest", "pipeline_key",
    "render_section", "reset_stats", "segment_identity", "snapshot",
    "ExportError", "LoadedArtifact", "export_stage", "fabricate_inputs",
    "guarded", "load_artifact",
]
