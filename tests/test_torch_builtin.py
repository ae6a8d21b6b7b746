"""The port's builtin:// models (backends/torch_backend.py), registry://
resolution (registry/models.py and the filter's ``_resolve_model``),
pbtxt (runtime/pbtxt.py), descriptions (runtime/describe.py) and
``queue.set_capacity`` against nnstreamer_tpu's.

Builtins: the same numpy inputs through ``jax.jit`` of nnstreamer_tpu's
builtin and through the port's, matmul and mlp carrying JAX's weights
through models/convert.py. Integer outputs and every dtype exact; float
outputs within rtol 1e-6, and the matmul/mlp products within rtol 1e-5 /
atol 1e-6 (float32 dot products summed in another order). pbtxt and
description strings equal nnstreamer_tpu's apart from the framework name."""
import json
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu.registry.elements as jreg
import nnstreamer_tpu.registry.models as jmodels
from nnstreamer_tpu.backends.jax_backend import _builtin_models
from nnstreamer_tpu.runtime import describe as jdescribe
from nnstreamer_tpu.runtime import pbtxt as jpbtxt
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
import nnstreamer_tpu_torch.core as tcore
import nnstreamer_tpu_torch.registry.elements as treg
import nnstreamer_tpu_torch.registry.models as tmodels
from nnstreamer_tpu_torch.backends.torch_backend import make_builtin
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.models.convert import builtin_params_from_jax
from nnstreamer_tpu_torch.runtime import describe as tdescribe
from nnstreamer_tpu_torch.runtime import pbtxt as tpbtxt
from nnstreamer_tpu_torch.runtime.parse import parse_launch

RTOL = 1e-6
MM_RTOL, MM_ATOL = 1e-5, 1e-6


def _inputs():
    rng = np.random.default_rng(42)
    return {
        "uint8": rng.integers(0, 256, (2, 3, 8)).astype(np.uint8),
        "int32": rng.integers(-100, 100, (2, 3, 8)).astype(np.int32),
        "float32": rng.standard_normal((2, 3, 8)).astype(np.float32),
        "float64": rng.standard_normal((2, 3, 8)),
    }


INPUTS = _inputs()

SIMPLE = [
    ("passthrough", {}), ("scaler", {}), ("scaler", {"factor": "0.5"}),
    ("add", {"value": "-3"}), ("average", {}), ("argmax", {}),
    ("sleeper", {"ms": "1", "factor": "3"}),
    ("sleeper", {"ms": "1", "factor": "1.5"}),
]


def _check(got, want, what, rtol=RTOL, atol=0.0):
    want = np.asarray(want)
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name, what
    assert tuple(got.shape) == want.shape, what
    if got.is_floating_point():
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


@pytest.mark.parametrize("dtype", sorted(INPUTS))
@pytest.mark.parametrize("name,params", SIMPLE,
                         ids=[f"{n}-{'-'.join(p.values())}" for n, p in SIMPLE])
def test_builtin_matches_jax(name, params, dtype):
    xs = [INPUTS[dtype], INPUTS["float32"][:, :1]]
    want = jax.jit(lambda *a: tuple(_builtin_models()[name](params)(*a)))(*xs)
    fn = make_builtin(f"builtin://{name}", params)
    got = fn(*(torch.from_numpy(x.copy()) for x in xs))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _check(g, w, f"{name} on {dtype}")
    # the shape rule: the outputs' specs without running the model
    info = tcore.TensorsInfo.of(*(tcore.TensorSpec(x.shape,
                                                   tcore.DataType.from_any(x.dtype))
                                  for x in xs))
    out = fn.output_info(info)
    assert [(s.shape, s.dtype.value) for s in out.specs] == \
        [(tuple(w.shape), np.dtype(w.dtype).name) for w in want]


def _jax_matmul_w(n):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, n),
                                        jnp.float32))


def _jax_mlp_weights(features, n, layers):
    key = jax.random.PRNGKey
    return {
        "w_in": np.asarray(jax.random.normal(key(layers + 1), (features, n),
                                             jnp.float32)),
        "w": [np.asarray(jax.random.normal(key(i), (n, n), jnp.float32))
              for i in range(layers)],
        "w_out": np.asarray(jax.random.normal(key(layers + 2), (n, 1),
                                              jnp.float32)),
    }


@pytest.mark.parametrize("dtype", sorted(INPUTS))
def test_matmul_with_jax_weights_matches(dtype):
    x = INPUTS[dtype]
    params = {"n": "8"}
    (want,) = jax.jit(_builtin_models()["matmul"](params))(x)
    fn = make_builtin("builtin://matmul?n=8", weights=builtin_params_from_jax(
        "matmul", {"w": _jax_matmul_w(8)}, "cpu"))
    (got,) = fn(torch.from_numpy(x.copy()))
    _check(got, want, f"matmul on {dtype}", MM_RTOL, MM_ATOL * np.abs(x).max())


@pytest.mark.parametrize("dtype", sorted(INPUTS))
def test_mlp_with_jax_weights_matches(dtype):
    x = INPUTS[dtype]
    params = {"n": "16", "layers": "3"}
    (want,) = jax.jit(lambda a: tuple(_builtin_models()["mlp"](params)(a)))(x)
    fn = make_builtin("builtin://mlp", params, weights=builtin_params_from_jax(
        "mlp", _jax_mlp_weights(24, 16, 3), "cpu"))
    (got,) = fn(torch.from_numpy(x.copy()))
    _check(got, want, f"mlp on {dtype}", MM_RTOL, MM_ATOL)


def test_own_weights_are_seeded_standard_normal():
    a = make_builtin("builtin://matmul?n=64")
    b = make_builtin("builtin://matmul?n=64")
    eye = torch.eye(64)
    (wa,), (wb,) = a(eye), b(eye)
    assert torch.equal(wa, wb)
    assert abs(wa.mean().item()) < 0.05 and abs(wa.var().item() - 1) < 0.1
    # mlp: JAX's seeds per layer (w_in layers+1, hidden i, w_out layers+2)
    def normal(shape, seed):
        return torch.randn(shape, generator=torch.Generator().manual_seed(seed))

    x = torch.linspace(-1, 1, 10).reshape(2, 5)
    h = torch.tanh(x @ (normal((5, 8), 3) * 0.1))
    for i in range(2):
        h = torch.tanh(h @ (normal((8, 8), i) * 0.05))
    (got,) = make_builtin("builtin://mlp?n=8&layers=2")(x)
    assert torch.equal(got, h @ normal((8, 1), 4))
    with pytest.raises(ValueError, match="given"):
        make_builtin("builtin://mlp?n=8&layers=1", weights={
            "w_in": torch.zeros(3, 8)})(torch.zeros(1, 5))


def test_unknown_builtin_is_refused():
    with pytest.raises(ValueError, match="unknown builtin model 'nope'"):
        make_builtin("builtin://nope")


def test_sleeper_sleeps_per_invoke_not_at_negotiation():
    fn = make_builtin("builtin://sleeper?ms=100")
    t0 = time.monotonic()
    fn.output_info(tcore.TensorsInfo.of(tcore.TensorSpec((2,), "float32")))
    assert time.monotonic() - t0 < 0.1
    t0 = time.monotonic()
    fn(*(torch.zeros(2) for _ in range(5)))
    elapsed = time.monotonic() - t0
    assert 0.1 <= elapsed < 0.4  # once per invoke; per tensor would be 0.5


def _caps(x):
    dims = ":".join(str(d) for d in reversed(x.shape))
    return f"other/tensors,format=static,dimensions={dims},types={x.dtype.name}"


def _run_line(parse, line, arrays):
    pipe = parse(line)
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    try:
        for a in arrays:
            pipe.get("in").push_buffer(a)
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=30)
        caps = pipe.get("out").sinkpad.caps
    finally:
        pipe.stop()
    return msg, caps, got


@pytest.mark.parametrize("model", [
    "builtin://passthrough", "builtin://scaler?factor=3",
    "builtin://add?value=0.5", "builtin://average", "builtin://argmax",
])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_builtin_launch_line_matches_jax(model, dtype):
    """framework=auto picks torch for builtin:// in the port (jax in
    nnstreamer_tpu)."""
    x = INPUTS[dtype]
    line = (f"appsrc name=in caps={_caps(x)} ! tensor_filter model={model} "
            "name=f {acc}! tensor_sink name=out")
    wmsg, wcaps, want = _run_line(jax_parse_launch, line.format(acc=""),
                                  [x, x + 1])
    gmsg, gcaps, got = _run_line(
        parse_launch, line.format(acc="accelerator=cpu "), [x, x + 1])
    assert wmsg.type.value == gmsg.type.value == "eos"
    assert str(gcaps) == str(wcaps)
    for g, w in zip(got, want):
        _check(g.tensors[0], w.tensors[0], model)


def test_builtin_line_without_a_card_posts_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    x = INPUTS["float32"]
    msg, _, got = _run_line(
        parse_launch, f"appsrc name=in caps={_caps(x)} ! tensor_filter "
        "model=builtin://scaler ! tensor_sink name=out", [x])
    assert msg.type is MessageType.ERROR and not got
    assert "no CUDA device" in str(msg.data)


# -- registry:// -------------------------------------------------------------

REGISTRY = {
    "scaler": {"active": "2", "versions": {
        "1": {"path": "builtin://scaler?factor=2"},
        "2": "builtin://scaler?factor=5"}},
    "adder": "builtin://add?value=7",
    "pinned": {"path": "builtin://passthrough", "framework": "torch"},
    "broken": {"framework": "torch"},
}


@pytest.fixture
def registry_file(tmp_path, monkeypatch):
    path = tmp_path / "models.json"
    path.write_text(json.dumps(REGISTRY))
    monkeypatch.setenv("NNS_TPU_MODEL_REGISTRY", str(path))
    return path


@pytest.mark.parametrize("uri", [
    "registry://scaler", "registry://scaler@1", "registry://scaler@2",
    "registry://adder", "registry://pinned", "builtin://scaler",
    "some.module:attr",
])
def test_resolve_matches_jax(registry_file, uri):
    assert tmodels.resolve(uri) == jmodels.resolve(uri)


@pytest.mark.parametrize("uri,exc", [
    ("registry://nope", KeyError), ("registry://scaler@9", KeyError),
    ("registry://adder@1", KeyError), ("registry://broken", KeyError),
])
def test_resolve_errors_match_jax(registry_file, uri, exc):
    with pytest.raises(exc) as want:
        jmodels.resolve(uri)
    with pytest.raises(exc) as got:
        tmodels.resolve(uri)
    assert str(got.value) == str(want.value)


def test_missing_registry_file(tmp_path, monkeypatch):
    monkeypatch.setenv("NNS_TPU_MODEL_REGISTRY", str(tmp_path / "none.json"))
    with pytest.raises(FileNotFoundError):
        tmodels.resolve("registry://x")


def test_local_overlay_shadows_the_file(registry_file):
    tmodels.register_local_model("scaler", {"path": "builtin://add?value=1"})
    try:
        assert tmodels.local_model_names() == ("scaler",)
        assert tmodels.resolve("registry://scaler") == \
            ("builtin://add?value=1", None)
    finally:
        tmodels.unregister_local_model("scaler")
    assert tmodels.resolve("registry://scaler") == \
        ("builtin://scaler?factor=5", None)


@pytest.mark.parametrize("uri,factor", [("registry://scaler", 5.0),
                                        ("registry://scaler@1", 2.0)])
def test_registry_model_in_a_launch_line(registry_file, uri, factor):
    x = INPUTS["float32"]
    line = (f"appsrc name=in caps={_caps(x)} ! tensor_filter model={uri} "
            "{acc}! tensor_sink name=out")
    _, wcaps, want = _run_line(jax_parse_launch, line.format(acc=""), [x])
    msg, gcaps, got = _run_line(parse_launch,
                                line.format(acc="accelerator=cpu "), [x])
    assert msg.type is MessageType.EOS and str(gcaps) == str(wcaps)
    _check(got[0].tensors[0], want[0].tensors[0], uri)
    np.testing.assert_allclose(got[0].tensors[0].numpy(), x * factor,
                               rtol=RTOL)


def test_unknown_registry_model_posts_an_error(registry_file):
    x = INPUTS["float32"]
    msg, _, got = _run_line(parse_launch, f"appsrc name=in caps={_caps(x)} "
                            "! tensor_filter model=registry://nope "
                            "accelerator=cpu ! tensor_sink name=out", [x])
    assert msg.type is MessageType.ERROR and not got
    assert "nope" in str(msg.data)


# -- pbtxt and describe -------------------------------------------------------

LINES = [
    "videotestsrc num-buffers=2 pattern=gradient ! videoconvert ! videoscale "
    "! video/x-raw,width=32,height=32,format=RGB ! tensor_converter "
    "frames-per-tensor=4 ! tensor_transform mode=arithmetic "
    "option=typecast:float32,add:-127.5,div:127.5 ! queue max-size-buffers=4 "
    "! tensor_filter framework={fw} model=builtin://scaler?factor=2 ! "
    "tensor_decoder mode=protobuf ! tensor_converter ! tensor_sink "
    "max-stored=1",
    "tensor_src num-buffers=3 dimensions=4 types=float32 ! tee name=t "
    "t. ! queue ! tensor_filter framework={fw} model=builtin://passthrough "
    "! tensor_sink t. ! queue leaky=downstream ! tensor_sink",
    "audiotestsrc num-buffers=1 samplesperbuffer=800 ! audioconvert ! "
    "audio/x-raw,format=S16LE,rate=8000,channels=1 ! tensor_converter ! "
    "tensor_sink",
]


@pytest.mark.parametrize("line", LINES, ids=["video", "tee", "audio"])
def test_pbtxt_round_trip_matches_jax(line):
    want = jpbtxt.to_pbtxt(jax_parse_launch(line.format(fw="jax")))
    got = tpbtxt.to_pbtxt(parse_launch(line.format(fw="torch")))
    assert got == want.replace("framework=jax", "framework=torch")
    back = tpbtxt.from_pbtxt(got)
    assert back == jpbtxt.from_pbtxt(want).replace("framework=jax",
                                                   "framework=torch")
    # and what it describes builds again, with the same pbtxt (a capsfilter
    # comes back as a node named "capsfilter", which neither package can
    # build: the format keeps no caps)
    if "/x-raw" not in line:
        assert tpbtxt.to_pbtxt(parse_launch(back)) == got


def test_from_pbtxt_errors_match_jax():
    for bad in ("node { input_stream: \"x\" }",
                "node { calculator: \"queueCalculator\"\n"
                "input_stream: \"nowhere\" }",
                "node { calculator: \"a\""):
        with pytest.raises(ValueError) as want:
            jpbtxt.from_pbtxt(bad)
        with pytest.raises(ValueError) as got:
            tpbtxt.from_pbtxt(bad)
        assert str(got.value) == str(want.value)


DESCRIPTION = {
    "name": "front",
    "elements": [
        {"factory": "videotestsrc", "name": "src",
         "props": {"num-buffers": 3, "pattern": "checkers"}},
        {"caps": "video/x-raw,width=8,height=8,format=RGB", "name": "cf"},
        {"factory": "tensor_converter", "name": "conv"},
        {"factory": "tee", "name": "t"},
        {"factory": "queue", "name": "q1"},
        {"factory": "tensor_transform", "name": "tr",
         "props": {"mode": "typecast", "option": "float32",
                   "accelerator": "cpu"}},
        {"factory": "tensor_sink", "name": "out"},
        {"factory": "queue", "name": "q2"},
        {"factory": "tensor_sink", "name": "raw"},
    ],
    "links": [["src", "cf"], ["cf", "conv"], ["conv", "t"], ["t", "q1"],
              ["q1", "tr"], ["tr", "out"], ["t", "q2"], ["q2", "raw"]],
}


def test_description_to_launch_matches_jax():
    desc = json.loads(json.dumps(DESCRIPTION))
    want = jdescribe.description_to_launch(
        json.loads(json.dumps(DESCRIPTION)))
    assert tdescribe.description_to_launch(desc) == want
    pipe = tdescribe.pipeline_from_description(DESCRIPTION)
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    assert pipe.wait(timeout=30).type is MessageType.EOS
    pipe.stop()
    assert len(got) == 3 and got[0].tensors[0].dtype is torch.float32


def test_launch_to_description_matches_jax():
    line = ("videotestsrc name=src num-buffers=2 ! "
            "video/x-raw,width=8,height=8 ! tensor_converter name=conv "
            "frames-per-tensor=2 ! queue name=q max-size-buffers=3 ! "
            "tensor_sink name=out")
    want = jdescribe.launch_to_description(line)
    got = tdescribe.launch_to_description(line)

    def canon(desc):  # the capsfilter's auto name holds a process counter
        return re.sub(r"capsfilter\d+", "capsfilter",
                      json.dumps(desc, sort_keys=True, default=str))

    assert canon(got) == canon(want)
    again = tdescribe.launch_to_description(
        tdescribe.description_to_launch(got))
    assert canon(again) == canon(jdescribe.launch_to_description(
        jdescribe.description_to_launch(want)))


def test_load_pipeline_file(tmp_path):
    path = tmp_path / "p.json"
    path.write_text(json.dumps(DESCRIPTION))
    pipe = tdescribe.load_pipeline_file(str(path))
    assert set(pipe.elements) >= {"src", "conv", "t", "tr", "out", "raw"}
    text = tmp_path / "p.txt"
    text.write_text("tensor_src num-buffers=1 ! tensor_sink name=out\n")
    assert "out" in tdescribe.load_pipeline_file(str(text)).elements


@pytest.mark.parametrize("desc,msg", [
    ({"elements": []}, "no elements"),
    ({"elements": [{"name": "x"}]}, "needs 'factory' or 'caps'"),
    ({"elements": [{"factory": "queue", "name": "a"},
                   {"factory": "queue", "name": "a"}]}, "duplicate"),
    ({"elements": [{"factory": "queue", "name": "a"}],
      "links": [["a", "b"]]}, "unknown element 'b'"),
])
def test_description_errors_match_jax(desc, msg):
    with pytest.raises(ValueError, match=msg):
        jdescribe.description_to_launch(json.loads(json.dumps(desc)))
    with pytest.raises(ValueError, match=msg):
        tdescribe.description_to_launch(json.loads(json.dumps(desc)))


# -- queue.set_capacity --------------------------------------------------------

PKGS = {"port": (tcore, treg), "jax": (__import__("nnstreamer_tpu.core",
                                                  fromlist=["Buffer"]), jreg)}


def _queue(pkg, **props):
    core, reg = PKGS[pkg]
    q = reg.make_element("queue", **props)
    sink = reg.make_element("tensor_sink", max_stored=0)
    q.link(sink)
    got = []
    sink.connect(lambda b: got.append(int(np.asarray(b.tensors[0])[0])))
    return q, got


@pytest.mark.parametrize("new_capacity", [4, 0])
def test_set_capacity_releases_a_blocked_producer_like_jax(new_capacity):
    results = {}
    for pkg in PKGS:
        core = PKGS[pkg][0]
        q, got = _queue(pkg, max_size_buffers=2)
        pushed = []

        def produce():
            for i in range(4):
                q.chain(q.sinkpad, core.Buffer([np.array([i], np.int32)]))
                pushed.append(i)

        t = threading.Thread(target=produce)
        t.start()
        deadline = time.monotonic() + 5
        while q.stats["level"] < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)
        blocked = (t.is_alive(), len(pushed))
        q.set_capacity(2)               # unchanged: not a retune
        q.set_capacity(new_capacity)
        t.join(timeout=2)
        released = not t.is_alive()
        stats = {k: q.stats[k] for k in ("level", "capacity", "retuned")}
        q.start()
        deadline = time.monotonic() + 5
        while len(got) < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        q.stop()
        results[pkg] = (blocked, released, stats, got)
    assert results["port"] == results["jax"]
    blocked, released, stats, got = results["port"]
    assert blocked == (True, 2) and released
    assert stats == {"level": 4, "capacity": new_capacity, "retuned": 1}
    assert got == [0, 1, 2, 3]


def test_set_capacity_lowered_applies_to_new_pushes():
    q, got = _queue("port", max_size_buffers=8)
    q.set_capacity(1)
    q.chain(q.sinkpad, tcore.Buffer([np.array([0], np.int32)]))
    t = threading.Thread(target=lambda: q.chain(
        q.sinkpad, tcore.Buffer([np.array([1], np.int32)])))
    t.start()
    time.sleep(0.2)
    assert t.is_alive() and q.stats["retuned"] == 1
    q.start()
    t.join(timeout=5)
    q.stop()
    assert not t.is_alive()
