"""The port stands alone: it imports with JAX blocked, loads nothing of
nnstreamer_tpu, and no file of it (nor chip_smoke.py) imports JAX, its
companions or nnstreamer_tpu."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "nnstreamer_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "nnstreamer_tpu")
SLICE_MODULES = [
    "nnstreamer_tpu_torch",
    "nnstreamer_tpu_torch.core",
    "nnstreamer_tpu_torch.runtime.parse",
    "nnstreamer_tpu_torch.registry.elements",
    "nnstreamer_tpu_torch.registry.subplugin",
    "nnstreamer_tpu_torch.registry.config",
    "nnstreamer_tpu_torch.backends.torch_backend",
    "nnstreamer_tpu_torch.elements.filter",
    "nnstreamer_tpu_torch.elements.src",
    "nnstreamer_tpu_torch.elements.sink",
    "nnstreamer_tpu_torch.elements.generate",
    "nnstreamer_tpu_torch.elements.decoder",
    "nnstreamer_tpu_torch.elements.aggregator",
    "nnstreamer_tpu_torch.runtime.queue",
    "nnstreamer_tpu_torch.runtime.queue_factory",
    "nnstreamer_tpu_torch.decoders",
    "nnstreamer_tpu_torch.decoders.base",
    "nnstreamer_tpu_torch.decoders.simple",
    "nnstreamer_tpu_torch.models.mobilenet_v2",
    "nnstreamer_tpu_torch.models._blocks",
    "nnstreamer_tpu_torch.models.tflite_import",
    "nnstreamer_tpu_torch.models.lm_serving",
    "nnstreamer_tpu_torch.models.decoding",
    "nnstreamer_tpu_torch.models.transformer",
    "nnstreamer_tpu_torch.models.convert",
    "nnstreamer_tpu_torch.ops.decode_attention",
    "nnstreamer_tpu_torch.ops.flash_attention",
    "nnstreamer_tpu_torch.utils.threads",
    "nnstreamer_tpu_torch.elements.tee",
    "nnstreamer_tpu_torch.elements.media",
    "nnstreamer_tpu_torch.elements.converter",
    "nnstreamer_tpu_torch.elements.transform",
    "nnstreamer_tpu_torch.ops.transform_ops",
    "nnstreamer_tpu_torch.converters",
    "nnstreamer_tpu_torch.converters.base",
    "nnstreamer_tpu_torch.converters.bytes_converter",
    "nnstreamer_tpu_torch.core.serialize",
    "nnstreamer_tpu_torch.core.wire_protobuf",
    "nnstreamer_tpu_torch.core.wire_flatbuf",
    "nnstreamer_tpu_torch.decoders.serialize",
    "nnstreamer_tpu_torch.registry.models",
    "nnstreamer_tpu_torch.runtime.pbtxt",
    "nnstreamer_tpu_torch.runtime.describe",
    "nnstreamer_tpu_torch.analysis",
    "nnstreamer_tpu_torch.analysis.sanitizer",
    "nnstreamer_tpu_torch.obs",
    "nnstreamer_tpu_torch.obs.context",
    "nnstreamer_tpu_torch.obs.flight",
    "nnstreamer_tpu_torch.obs.metrics",
    "nnstreamer_tpu_torch.obs.memory",
    "nnstreamer_tpu_torch.utils.stats",
    "nnstreamer_tpu_torch.serving",
    "nnstreamer_tpu_torch.serving.request",
    "nnstreamer_tpu_torch.serving.queue",
    "nnstreamer_tpu_torch.serving.batcher",
    "nnstreamer_tpu_torch.serving.metrics",
    "nnstreamer_tpu_torch.serving.scheduler",
    "nnstreamer_tpu_torch.serving.kv_pool",
    "nnstreamer_tpu_torch.serving.lm_engine",
    "nnstreamer_tpu_torch.serving.speculative",
    "nnstreamer_tpu_torch.elements.serving",
    "nnstreamer_tpu_torch.ops.nms",
    "nnstreamer_tpu_torch.decoders.font",
    "nnstreamer_tpu_torch.decoders.bbox_classic",
    "nnstreamer_tpu_torch.decoders.bounding_boxes",
    "nnstreamer_tpu_torch.decoders.segment_pose",
    "nnstreamer_tpu_torch.models.ssd_mobilenet",
    "nnstreamer_tpu_torch.models.posenet",
    "nnstreamer_tpu_torch.models.deeplab",
    "nnstreamer_tpu_torch.utils.trace",
    "nnstreamer_tpu_torch.runtime.pad",
    "nnstreamer_tpu_torch.runtime.element",
    "nnstreamer_tpu_torch.runtime.pipeline",
    "nnstreamer_tpu_torch.obs.profile",
    "nnstreamer_tpu_torch.obs.quality",
    "nnstreamer_tpu_torch.obs.slo",
    "nnstreamer_tpu_torch.elements.fault",
    "nnstreamer_tpu_torch.single",
    "nnstreamer_tpu_torch.elements.muxdemux",
    "nnstreamer_tpu_torch.elements.mergesplit",
    "nnstreamer_tpu_torch.elements.cond",
    "nnstreamer_tpu_torch.elements.crop",
    "nnstreamer_tpu_torch.elements.rate",
    "nnstreamer_tpu_torch.elements.repo",
    "nnstreamer_tpu_torch.elements.files",
    "nnstreamer_tpu_torch.elements.join",
    "nnstreamer_tpu_torch.elements.debug",
    "nnstreamer_tpu_torch.elements.sparse",
    "nnstreamer_tpu_torch.compat",
    "nnstreamer_tpu_torch.compat.nnstreamer_python",
    "nnstreamer_tpu_torch.backends.python_backend",
    "nnstreamer_tpu_torch.backends.custom_easy",
    "nnstreamer_tpu_torch.backends.custom_c",
    "nnstreamer_tpu_torch.converters.python_converter",
    "nnstreamer_tpu_torch.decoders.python_decoder",
    "nnstreamer_tpu_torch.elements.datarepo",
    "nnstreamer_tpu_torch.elements.iio",
    "nnstreamer_tpu_torch.models.tflite_schema",
    "nnstreamer_tpu_torch.models.tflite_int8",
    "nnstreamer_tpu_torch.models.tflite_q8_native",
    "nnstreamer_tpu_torch.native",
    "nnstreamer_tpu_torch.native.q8",
    "nnstreamer_tpu_torch.backends.tflite_backend",
    "nnstreamer_tpu_torch.backends.tf_backend",
    "nnstreamer_tpu_torch.utils.parity",
    "nnstreamer_tpu_torch.ops.fma_gemm",
    "nnstreamer_tpu_torch.transport",
    "nnstreamer_tpu_torch.transport.frame",
    "nnstreamer_tpu_torch.transport.shm",
    "nnstreamer_tpu_torch.transport.stats",
    "nnstreamer_tpu_torch.query",
    "nnstreamer_tpu_torch.query.protocol",
    "nnstreamer_tpu_torch.query.client",
    "nnstreamer_tpu_torch.query.server",
    "nnstreamer_tpu_torch.query.edge",
    "nnstreamer_tpu_torch.query.mqtt",
    "nnstreamer_tpu_torch.query.hybrid",
    "nnstreamer_tpu_torch.query.elements",
    "nnstreamer_tpu_torch.query.grpc_io",
    "nnstreamer_tpu_torch.elements.shard",
    "nnstreamer_tpu_torch.elements.mqtt",
    "nnstreamer_tpu_torch.utils.ntp",
    "nnstreamer_tpu_torch.obs.promtext",
]
# the slice that needs no TensorFlow to import: blocked too when checked
TFLITE_MODULES = [
    "nnstreamer_tpu_torch.models.tflite_schema",
    "nnstreamer_tpu_torch.models.tflite_int8",
    "nnstreamer_tpu_torch.models.tflite_q8_native",
    "nnstreamer_tpu_torch.native",
    "nnstreamer_tpu_torch.native.q8",
    "nnstreamer_tpu_torch.backends.tflite_backend",
    "nnstreamer_tpu_torch.backends.tf_backend",
    "nnstreamer_tpu_torch.utils.parity",
    "nnstreamer_tpu_torch.models.tflite_import",
    "nnstreamer_tpu_torch.backends.torch_backend",
    "nnstreamer_tpu_torch.elements.datarepo",
]
# the transport and query slice: imports and serves with grpc blocked too
QUERY_ELEMENTS = {"tensor_query_client", "tensor_query_serversrc",
                  "tensor_query_serversink", "edgesrc", "edgesink",
                  "tensor_src_grpc", "tensor_sink_grpc", "mqttsrc",
                  "mqttsink", "tensor_shard", "tensor_unshard"}


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_imports_with_jax_blocked():
    code = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None      # any import of them raises ImportError
import importlib
for mod in {SLICE_MODULES!r}:
    importlib.import_module(mod)
from nnstreamer_tpu_torch.registry.elements import element_factories
from nnstreamer_tpu_torch.registry.subplugin import SubpluginKind, get
assert {{"appsrc", "tensor_filter", "tensor_generate", "tensor_sink",
         "tensor_src", "queue", "tensor_aggregator",
         "tensor_decoder", "tee", "videotestsrc", "videoconvert",
         "videoscale", "imagefreeze", "audiotestsrc", "audioconvert",
         "tensor_converter", "tensor_transform",
         "tensor_serving", "tensor_fault"}} <= set(element_factories())
assert get(SubpluginKind.FILTER, "torch") is get(SubpluginKind.FILTER, "pytorch")
assert get(SubpluginKind.DECODER, "image_labeling").MODE == "image_labeling"
for mode in ("flexbuf", "protobuf", "flatbuf"):
    assert get(SubpluginKind.DECODER, mode).MODE == mode
    assert get(SubpluginKind.CONVERTER, mode).NAME == mode
for mode in ("bounding_boxes", "pose_estimation", "image_segment",
             "tensor_region", "font"):
    assert get(SubpluginKind.DECODER, mode).MODE == mode
from nnstreamer_tpu_torch.registry.subplugin import names
assert names(SubpluginKind.FILTER) == ["custom", "custom-easy", "python",
                                       "tensorflow", "tflite", "torch"]
assert get(SubpluginKind.FILTER, "python3") is get(SubpluginKind.FILTER,
                                                   "python")
assert get(SubpluginKind.DECODER, "python3").MODE == "python3"
assert get(SubpluginKind.CONVERTER, "python3").NAME == "python3"
assert {{"videomixer", "compositor", "datareposrc", "datareposink",
         "tensor_src_iio"}} <= set(element_factories())
assert {QUERY_ELEMENTS!r} <= set(element_factories())
assert len(element_factories()) == 59
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and (m == "nnstreamer_tpu" or m.startswith("nnstreamer_tpu."))]
assert not loaded, loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_tflite_slice_imports_with_tensorflow_blocked(tmp_path):
    """The .tflite slice imports, loads the fixture and runs it in every
    mode with jax, nnstreamer_tpu and tensorflow blocked; the two TF
    backends register and fail only in open(), naming tensorflow."""
    code = f"""
import sys
for name in {FORBIDDEN + ("tensorflow",)!r}:
    sys.modules[name] = None
import importlib
for mod in {TFLITE_MODULES!r}:
    importlib.import_module(mod)
import numpy as np, torch
from nnstreamer_tpu_torch import native
from nnstreamer_tpu_torch.native import q8
from nnstreamer_tpu_torch.models.tflite_import import load_tflite
from nnstreamer_tpu_torch.backends.base import (FilterProperties,
                                                FrameworkUnavailable)
from nnstreamer_tpu_torch.registry.subplugin import SubpluginKind, get
path = "tests/fixtures/tiny_int8_perchannel.tflite"
x = torch.zeros((1, 16, 16, 3), dtype=torch.int8)
modes = ["fake-quant", "float", "int8"]
if native.available() and q8.available():
    modes.append("int8-native")
for mode in modes:
    out = load_tflite(path, {{"quantized_exec": mode}}, device="cpu")[0](x)
    assert tuple(out[0].shape) == (1, 10)
for name in ("tflite", "tensorflow-lite", "tensorflow", "tf"):
    try:
        get(SubpluginKind.FILTER, name)().open(FilterProperties(model=path))
    except FrameworkUnavailable as e:
        assert "tensorflow" in str(e)
    else:
        raise AssertionError(name)
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and (m == "nnstreamer_tpu" or m.startswith("nnstreamer_tpu.")
               or m == "tensorflow" or m.startswith("tensorflow."))]
assert not loaded, loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_query_slice_serves_with_grpc_blocked():
    """With jax, nnstreamer_tpu and grpc blocked, the transport and query
    modules import, their elements register, a query server line answers a
    client over NNSB with the shm ring, and the grpc elements fail only
    when they open, naming grpc."""
    code = f"""
import sys, time
for name in {FORBIDDEN + ("grpc",)!r}:
    sys.modules[name] = None
import numpy as np
from nnstreamer_tpu_torch.registry.elements import element_factories
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.core import MessageType
assert {QUERY_ELEMENTS!r} <= set(element_factories())
caps = "other/tensors,format=static,dimensions=4,types=float32"
srv = parse_launch("tensor_query_serversrc name=s id=5 port=0 caps=" + caps
                   + " ! tensor_filter framework=torch accelerator=cpu "
                   "model=builtin://scaler?factor=2 ! tensor_query_serversink id=5")
srv.play()
deadline = time.monotonic() + 10
while srv.get("s").bound_port == 0 and time.monotonic() < deadline:
    time.sleep(0.01)
cli = parse_launch("appsrc name=in caps=" + caps + " ! tensor_query_client "
                   "name=q port=" + str(srv.get("s").bound_port)
                   + " ! tensor_sink name=out")
got = []
cli.get("out").connect(got.append)
cli.play()
cli.get("in").push_buffer(np.ones(4, np.float32))
deadline = time.monotonic() + 30
while not got and time.monotonic() < deadline:
    time.sleep(0.01)
q = cli.get("q").client
assert (q.wire_format, q.shm_active) == ("binary", True)
assert float(np.asarray(got[0].tensors[0])[0]) == 2.0
cli.stop(); srv.stop()
g = parse_launch("tensor_src_grpc server=true port=0 caps=" + caps
                 + " ! tensor_sink")
g.play()
msg = g.bus.wait_for((MessageType.ERROR,), timeout=10)
g.stop()
assert msg is not None and "grpc" in msg.data["error"], msg
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and (m == "nnstreamer_tpu" or m.startswith("nnstreamer_tpu.")
               or m == "grpc" or m.startswith("grpc."))]
assert not loaded, loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_zoo_line_constructs_with_jax_blocked():
    """The SSD line's decoder and filter entry construct, and the decoder
    decodes a CPU batch through its reduce, with no JAX to import."""
    code = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
import numpy as np
import torch
from nnstreamer_tpu_torch.core import Buffer
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.models import ssd_mobilenet
pipe = parse_launch(
    "appsrc name=in caps=other/tensors,format=static,num_tensors=2,"
    "dimensions=4:255:2.91:255:2,types=float32,float32 "
    "! tensor_decoder mode=bounding_boxes option1=mobilenet-ssd-postprocess "
    "option3=,30 option4=64:64 frames-in=2 ! tensor_sink name=out")
got = []
pipe.get("out").connect(got.append)
pipe.play()
g = torch.Generator().manual_seed(0)
boxes = torch.rand(2, 255, 4, generator=g).sort(-1).values
pipe.get("in").push_buffer(Buffer([boxes, torch.rand(2, 255, 91, generator=g)]))
pipe.get("in").end_of_stream()
msg = pipe.wait(timeout=60)
pipe.stop()
assert msg.type.value == "eos", msg
assert len(got) == 2 and got[0].tensors[0].shape == (64, 64, 4)
served = ssd_mobilenet.filter_model_u8.make("cpu")
assert served.dtype is torch.float32
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and (m == "nnstreamer_tpu" or m.startswith("nnstreamer_tpu."))]
assert not loaded, loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_stream_elements_construct_and_run_with_jax_blocked(tmp_path):
    """A line using each of the stream-structure, file and sink elements
    constructs, and the mux/if/merge/split line and SingleShot run on the
    CPU, with no JAX to import."""
    data = tmp_path / "d.raw"
    data.write_bytes(bytes(range(16)))
    code = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
import numpy as np
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.single import SingleShot
lines = [
    "tensor_src num-buffers=4 dimensions=3:4:4:2 types=uint8 "
    "pattern=random ! tensor_if compared-value=a-value operator=lt "
    "supplied-value=64 then=passthrough else=skip ! tee name=t "
    "t. ! queue ! m.sink_0 t. ! queue ! m.sink_1 tensor_mux name=m "
    "! tensor_demux name=d tensorpick=0,1 d.src_0 ! tensor_sink name=a "
    "d.src_1 ! tensor_debug ! fakesink",
    "tensor_src num-buffers=2 dimensions=3:4 types=float32 ! tee name=t "
    "t. ! queue ! m.sink_0 t. ! queue ! m.sink_1 tensor_merge name=m "
    "option=0 ! tensor_split name=s axis=0 tensorseg=4,4 "
    "s.src_0 ! tensor_sink name=a s.src_1 ! tensor_rate framerate=0 "
    "! tensor_sparse_enc ! tensor_sparse_dec ! fakesink",
    "filesrc location={data} ! tensor_converter input-dim=16 "
    "input-type=uint8 ! tensor_repo_sink slot-index=3",
    "multifilesrc location={data} stop-index=0 ! tensor_converter "
    "input-dim=16 input-type=uint8 ! filesink location={tmp_path}/o.raw",
    "tensor_reposrc slot-index=3 caps=other/tensors,format=static,"
    "dimensions=16,types=uint8 ! multifilesink location={tmp_path}/m_%d",
    "tensor_src_callable dimensions=2 ! join name=j ! tensor_sink "
    "tensor_crop name=c ! tensor_sink tensor_src ! c.raw "
    "tensor_src dimensions=4 ! c.info",
    "filesrc location={data} ! pngdec ! fakesink",
    "filesrc location={data} ! imagedec ! fakesink",
    "filesrc location={data} ! pnmdec ! fakesink",
    "tensor_src ! tensor_reposink slot-index=5",
]
for line in lines:
    parse_launch(line)
for line in lines[:2]:
    parse_launch(line).run(timeout=60)
with SingleShot("torch", "builtin://scaler?factor=2", accelerator="cpu",
                timeout_ms=5000) as s:
    assert float(s.invoke(np.ones(2, np.float32))[0][0]) == 2.0
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and (m == "nnstreamer_tpu" or m.startswith("nnstreamer_tpu."))]
assert not loaded, loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_plugin_lines_run_with_jax_blocked(tmp_path):
    """A python filter, a reference-style python3 decoder, custom-easy, a
    compositor and a datarepo round trip run on the CPU with no JAX to
    import."""
    script = tmp_path / "f.py"
    script.write_text("import numpy as np\n"
                      "class Filter:\n"
                      "    def invoke(self, inputs):\n"
                      "        return [np.asarray(inputs[0]) * 2]\n")
    dec = tmp_path / "d.py"
    dec.write_text("import nnstreamer_python\n"
                   "class CustomDecoder(object):\n"
                   "    def getOutCaps(self):\n"
                   "        return b'application/octet-stream'\n"
                   "    def decode(self, raw, info, n, d):\n"
                   "        return raw[0]\n")
    code = f"""
import sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None
import numpy as np
from nnstreamer_tpu_torch.backends.custom_easy import register_custom_easy
from nnstreamer_tpu_torch.runtime.parse import parse_launch
register_custom_easy("neg", lambda ts: [-np.asarray(ts[0])])
lines = [
    "tensor_src num-buffers=2 dimensions=4 types=float32 pattern=ones ! "
    "tensor_filter framework=python model={script} ! tensor_filter "
    "framework=custom-easy model=neg ! tensor_decoder mode=python3 "
    "option1={dec} ! tensor_sink name=out",
    "videotestsrc num-buffers=2 ! videoconvert ! videoscale ! "
    "video/x-raw,width=8,height=8,format=RGB ! tee name=t t. ! queue ! "
    "mix.sink_0 t. ! queue ! mix.sink_1 compositor name=mix ! "
    "tensor_sink name=out",
    "tensor_src num-buffers=2 dimensions=4 types=bfloat16 ! datareposink "
    "location={tmp_path}/d.raw json={tmp_path}/d.json",
    "datareposrc location={tmp_path}/d.raw json={tmp_path}/d.json ! "
    "tensor_sink name=out",
]
for line in lines:
    parse_launch(line).run(timeout=60)
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and (m == "nnstreamer_tpu" or m.startswith("nnstreamer_tpu."))]
assert not loaded, loaded
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
