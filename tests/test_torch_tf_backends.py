"""The port's tflite and tensorflow backends (``framework=tflite`` with its
aliases, ``framework=tensorflow``): the cases of ``test_tf_backends.py``
through the port's launch lines, against nnstreamer_tpu's pipelines on the
same models, plus what is the port's own: card tensors cross to the host
once, bfloat16 is refused, and without TensorFlow opening fails with a
typed error naming it (a bus ERROR in a pipeline), never a quiet switch to
the importer."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from nnstreamer_tpu.registry.config import get_config as ref_config  # noqa: E402
from nnstreamer_tpu.runtime.parse import parse_launch as ref_parse  # noqa: E402
from nnstreamer_tpu_torch.backends.base import (  # noqa: E402
    Accelerator, FilterProperties, check_accelerator)
from nnstreamer_tpu_torch.backends.tf_backend import TensorFlowBackend  # noqa: E402
from nnstreamer_tpu_torch.backends.tflite_backend import TFLiteBackend  # noqa: E402
from nnstreamer_tpu_torch.registry.config import get_config  # noqa: E402
from nnstreamer_tpu_torch.runtime.parse import parse_launch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tflite_model(tmp_path_factory):
    @tf.function(input_signature=[tf.TensorSpec([1, 4], tf.float32)])
    def affine(x):
        return x * 3 + 1

    conv = tf.lite.TFLiteConverter.from_concrete_functions(
        [affine.get_concrete_function()])
    path = tmp_path_factory.mktemp("models") / "affine.tflite"
    path.write_bytes(conv.convert())
    return str(path)


@pytest.fixture(scope="module")
def saved_model(tmp_path_factory):
    class Affine(tf.Module):
        @tf.function(input_signature=[tf.TensorSpec([1, 4], tf.float32)])
        def __call__(self, x):
            return x * 3 + 1

    path = tmp_path_factory.mktemp("models") / "affine_saved"
    tf.saved_model.save(Affine(), str(path))
    return str(path)


@pytest.fixture(scope="module")
def frozen_graph(tmp_path_factory):
    """A frozen GraphDef (the reference TF subplugin's native format):
    input ``input`` (1, 784), a dense layer, output ``softmax``."""
    g = tf.Graph()
    rng = np.random.default_rng(0)
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, [1, 784], name="input")
        w = tf.constant(rng.standard_normal((784, 10)).astype(np.float32)
                        * 0.05)
        tf.nn.softmax(tf.matmul(x, w), name="softmax")
    path = tmp_path_factory.mktemp("models") / "dense.pb"
    path.write_bytes(g.as_graph_def().SerializeToString())
    return str(path)


def test_auto_detect_tflite_extension(tflite_model):
    assert get_config().framework_priority(tflite_model) == ["tflite"] \
        == ref_config().framework_priority(tflite_model)


def test_auto_detect_saved_model_dir(saved_model):
    assert get_config().framework_priority(saved_model) == ["tensorflow"] \
        == ref_config().framework_priority(saved_model)
    assert get_config().get("tensorflow", "signature") == "serving_default"


def _run(parse, model, framework="auto"):
    pipe = parse(
        "tensor_src num-buffers=3 dimensions=4:1 types=float32 pattern=counter "
        f"! tensor_filter framework={framework} model={model} "
        "! tensor_sink name=out max-stored=8")
    outs = []
    pipe.get("out").connect(lambda b: outs.append(np.asarray(b.tensors[0])))
    pipe.play()
    pipe.wait(timeout=60)
    pipe.stop()
    return outs


@pytest.mark.parametrize("framework", [
    "auto", "tflite", "tensorflow-lite", "tensorflow2-lite",
    "tensorflow1-lite"])
def test_tflite_pipeline_matches_reference(tflite_model, framework):
    outs = _run(parse_launch, tflite_model, framework)
    assert len(outs) == 3
    np.testing.assert_allclose(outs[1], np.full((1, 4), 4.0, np.float32))
    for a, b in zip(outs, _run(ref_parse, tflite_model, framework)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("framework", ["auto", "tensorflow", "tf",
                                       "tensorflow2"])
def test_saved_model_pipeline_matches_reference(saved_model, framework):
    outs = _run(parse_launch, saved_model, framework)
    assert len(outs) == 3
    np.testing.assert_allclose(outs[2], np.full((1, 4), 7.0, np.float32))
    for a, b in zip(outs, _run(ref_parse, saved_model, framework)):
        np.testing.assert_array_equal(a, b)


def test_tflite_dynamic_batch_resize(tflite_model):
    b = TFLiteBackend()
    b.open(FilterProperties(model=tflite_model))
    try:
        x = np.ones((5, 4), np.float32)
        np.testing.assert_allclose(np.asarray(b.invoke([x])[0]), 4.0)
        assert b.invoke([x])[0].shape == (5, 4)
        # a CPU torch tensor (what a card tensor becomes after its one
        # pull) is accepted the same way
        got = b.invoke([torch.ones(2, 4)])[0]
        np.testing.assert_allclose(got, np.full((2, 4), 4.0, np.float32))
    finally:
        b.close()


@pytest.mark.parametrize("cls,model", [(TFLiteBackend, "tflite_model"),
                                       (TensorFlowBackend, "saved_model")])
def test_bfloat16_input_refused(request, cls, model):
    b = cls()
    b.open(FilterProperties(model=request.getfixturevalue(model)))
    try:
        with pytest.raises(TypeError, match="bfloat16"):
            b.invoke([torch.ones(1, 4, dtype=torch.bfloat16)])
    finally:
        b.close()


@pytest.mark.parametrize("cls", [TFLiteBackend, TensorFlowBackend])
def test_host_backends_refuse_the_card(cls):
    with pytest.raises(ValueError, match="runs on cpu only"):
        check_accelerator(cls(), FilterProperties(
            model="m", accelerator=Accelerator.GPU))


@pytest.mark.parametrize("custom", ["", "inputs:input,outputs:softmax"])
def test_frozen_graphdef_matches_reference(frozen_graph, custom):
    from nnstreamer_tpu.backends.base import FilterProperties as RProps
    from nnstreamer_tpu.backends.tf_backend import \
        TensorFlowBackend as RefBackend

    x = np.random.default_rng(1).random((1, 784)).astype(np.float32)
    be, ref = TensorFlowBackend(), RefBackend()
    be.open(FilterProperties(model=frozen_graph, custom=custom))
    ref.open(RProps(model=frozen_graph, custom=custom))
    try:
        (out,) = be.invoke([x])
        assert out.shape == (1, 10) and np.isclose(out.sum(), 1.0, atol=1e-4)
        np.testing.assert_array_equal(out, ref.invoke([x])[0])
        assert [str(i) for i in be.get_model_info()] == \
            [str(i) for i in ref.get_model_info()]
    finally:
        be.close()
        ref.close()


def test_frozen_graph_pipeline_with_explicit_names(frozen_graph):
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        "dimensions=784:1,types=float32 "
        f"! tensor_filter framework=tensorflow model={frozen_graph} "
        "custom=inputs:input,outputs:softmax "
        "! tensor_decoder mode=image_labeling ! tensor_sink name=out")
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    pipe.get("in").push_buffer(np.random.rand(1, 784).astype(np.float32))
    pipe.get("in").end_of_stream()
    pipe.wait(timeout=30)
    pipe.stop()
    assert got and 0 <= got[0].meta["label_index"] < 10


def test_unknown_signature_refused_as_reference(saved_model):
    from nnstreamer_tpu.backends.base import FilterProperties as RProps
    from nnstreamer_tpu.backends.tf_backend import \
        TensorFlowBackend as RefBackend

    msgs = []
    for be, props in ((TensorFlowBackend(), FilterProperties),
                      (RefBackend(), RProps)):
        with pytest.raises(ValueError, match="no signature") as e:
            be.open(props(model=saved_model, custom="signature:nope"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_without_tensorflow_a_typed_bus_error(tflite_model):
    """With TensorFlow absent (blocked here), framework=tflite, its aliases
    and framework=auto on a .tflite post a FrameworkUnavailable naming
    tensorflow; nothing runs through the importer instead."""
    code = f"""
import sys
sys.modules["tensorflow"] = None
from nnstreamer_tpu_torch.backends.base import FilterProperties, FrameworkUnavailable
from nnstreamer_tpu_torch.backends.tflite_backend import TFLiteBackend
from nnstreamer_tpu_torch.backends.tf_backend import TensorFlowBackend
from nnstreamer_tpu_torch.runtime.parse import parse_launch
for cls in (TFLiteBackend, TensorFlowBackend):
    try:
        cls().open(FilterProperties(model={tflite_model!r}))
    except FrameworkUnavailable as e:
        assert "tensorflow" in str(e), e
    else:
        raise AssertionError("opened without tensorflow")
for fw in ("auto", "tflite", "tensorflow2-lite"):
    pipe = parse_launch("tensor_src num-buffers=1 dimensions=4:1 "
                        "types=float32 ! tensor_filter framework=" + fw +
                        " model={tflite_model} ! tensor_sink name=out")
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    msg = pipe.wait(timeout=30)
    pipe.stop()
    assert msg.type.name == "ERROR", msg
    assert "FrameworkUnavailable" in str(msg) and "tensorflow" in str(msg)
    assert not got
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_parity_harness_labels_agree(tmp_path, monkeypatch):
    """utils/parity.py: the same frames through the tflite interpreter,
    through framework=torch on the same .tflite, and through a registered
    torch entry computing the same function give the same labels."""
    from nnstreamer_tpu_torch.utils import parity

    @tf.function(input_signature=[tf.TensorSpec([1, 224, 224, 3],
                                                tf.float32)])
    def pooled(x):
        return tf.reshape(tf.nn.avg_pool2d(x, 56, 56, "VALID"), [1, -1])

    path = tmp_path / "pooled.tflite"
    path.write_bytes(tf.lite.TFLiteConverter.from_concrete_functions(
        [pooled.get_concrete_function()]).convert())

    def entry(x):
        n = x.shape[0]
        return (x.reshape(n, 4, 56, 4, 56, 3).mean(dim=(2, 4))
                .reshape(n, -1),)

    monkeypatch.setitem(sys.modules, "parity_entry", None)
    model = parity.register_entry_module("parity_entry", entry)
    assert model == "parity_entry:entry"
    rng = np.random.default_rng(4)
    frames = [rng.random((1, 224, 224, 3), np.float32) for _ in range(3)]
    want = parity.labels_through("tflite", str(path), frames)
    assert len(want) == 3
    assert parity.labels_through("torch", str(path), frames,
                                 extra="accelerator=cpu") == want
    assert parity.labels_through("torch", model, frames,
                                 extra="accelerator=cpu") == want
