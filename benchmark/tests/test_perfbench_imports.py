"""The import boundary: nothing the benchmark runs holds JAX or the JAX
package (top-level names compared whole, since the port's name begins
with the JAX package's), and the plain references hold nothing of the
program either. Each check runs in a fresh process: the test runner's
own process may hold anything."""
import json
import subprocess
import sys

from benchmark import core

RUN = r"""
import json, sys, time
sys.path.insert(0, {root!r})
from benchmark import core
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _modules(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", RUN.format(root=str(core.ROOT), body=body)],
                         capture_output=True, text=True, timeout=600, cwd="/")
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_whole_run_holds_no_jax():
    mods = _modules("""
cell = core.find_cell(core.load_manifest(), "mobilenet_v2_bf16.nvdec_live_b16")
cell.traffic.update(frame=[32, 32, 3], frames_per_buffer=2, rate_frames_per_s=40,
                    pool_buffers=2, warmup_buffers=1, sample_buffers=1)
res = core.run_cell(cell, 2**31 + 3, 0.5, False, time.perf_counter(), "cpu")
assert res["attempted"] > 0
for name in ("benchmark.sweep", "benchmark.calibrate", "benchmark.systems.tflite_int8"):
    __import__(name)
for m in core.load_manifest()["end_to_end"] + core.load_manifest()["per_layer"]:
    core.load_reader(m["name"])
""")
    assert "nnstreamer_tpu_torch" in mods
    assert not mods & set(core.FORBIDDEN), mods & set(core.FORBIDDEN)


def test_the_references_hold_nothing_of_the_program():
    mods = _modules("""
import benchmark.references.mobilenet_v2, benchmark.references.tflite_int8
import benchmark.flops, benchmark.stats, benchmark.trace, benchmark.traffic.generator
""")
    assert not mods & {"nnstreamer_tpu_torch", *core.FORBIDDEN}


def test_forbidden_names_are_compared_whole():
    assert core.forbidden_modules(["nnstreamer_tpu_torch.models", "numpy", "jaxtyping"]) == []
    assert core.forbidden_modules(["nnstreamer_tpu.models.x", "jaxlib", "flax.linen",
                                   "jax"]) == ["flax", "jax", "jaxlib", "nnstreamer_tpu"]
