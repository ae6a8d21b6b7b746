"""The port's filter subplugins ``custom`` (C/C++ plugins), ``custom-easy``
and ``python``, the ``python3`` converter and decoder and the
``nnstreamer_python`` shim, held against nnstreamer_tpu.

Each case runs nnstreamer_tpu and the port on the same inputs (numpy,
seeded) and compares the outputs exactly — values, dtypes, shapes and
the caps at the sink; a bfloat16 tensor through its uint16 bit patterns
(``ml_dtypes`` in nnstreamer_tpu, a CPU ``torch.bfloat16`` here). The C
and C++ plugins are compiled once with g++ against the port's copy of the
ABI headers (``nnstreamer_tpu_torch/native/csrc``), and that one ``.so``
is loaded by both packages. The cases mirror tests/test_custom_c.py,
test_custom_cpp.py, test_repo_rnn.py, test_filter.py::TestPythonBackend
and the python converter/decoder cases of test_decoders.py."""
import os
import re
import shutil
import subprocess
import tempfile
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends import custom_c as jcustom_c
from nnstreamer_tpu.backends import custom_easy as jcustom_easy
from nnstreamer_tpu.backends.base import FilterProperties as JProps
from nnstreamer_tpu.core import DataType as JDataType
from nnstreamer_tpu.core import TensorsInfo as JInfo
from nnstreamer_tpu.core.tensors import TensorSpec as JSpec
from nnstreamer_tpu.elements.repo import REPO as JREPO
from nnstreamer_tpu.registry.config import get_config as jget_config
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.backends import custom_c, custom_easy
from nnstreamer_tpu_torch.backends.base import FilterProperties
from nnstreamer_tpu_torch.core import DataType, MessageType, TensorsInfo
from nnstreamer_tpu_torch.core.buffer import bf16_bits
from nnstreamer_tpu_torch.core.tensors import TensorSpec
from nnstreamer_tpu_torch.elements.repo import REPO
from nnstreamer_tpu_torch.registry.config import get_config
from nnstreamer_tpu_torch.runtime.parse import parse_launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_INCLUDE = os.path.join(ROOT, "nnstreamer_tpu_torch", "native", "csrc")
REF_INCLUDE = os.path.join(ROOT, "nnstreamer_tpu", "native", "csrc")
SCALER = os.path.join(ROOT, "examples", "custom_filters", "scaler.cc")
OFFSET = os.path.join(ROOT, "examples", "custom_filters", "offset.cc")

_built = {}


def build_plugin(source: str, name: str) -> str:
    """Compile a plugin (a .cc path or inline source) against the port's
    headers into a cached .so."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    if (source, name) in _built:
        return _built[(source, name)]
    out = tempfile.mkdtemp(prefix="nns_torch_custom_")
    src = source
    if not os.path.exists(source):
        src = os.path.join(out, f"{name}.cc")
        with open(src, "w") as fh:
            fh.write(source)
    so = os.path.join(out, f"lib{name}.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-I",
                    PORT_INCLUDE, "-o", so, src], check=True,
                   capture_output=True)
    _built[(source, name)] = so
    return so


def rec(t):
    """(dtype, shape, bytes); bfloat16 through its uint16 bit patterns."""
    if isinstance(t, torch.Tensor):
        if t.dtype is torch.bfloat16:
            return ("bfloat16", tuple(t.shape), bf16_bits(t).tobytes())
        t = t.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(t))
    if a.dtype.name == "bfloat16":
        return ("bfloat16", a.shape, a.view(np.uint16).tobytes())
    return (a.dtype.name, a.shape, a.tobytes())


def run_both(line, pushes=None, timeout=30):
    """The line through both packages: per package the sink's buffers as
    records and its caps string."""
    res = []
    for parse in (jax_parse_launch, parse_launch):
        pipe = parse(line)
        got = []
        pipe.get("out").connect(
            lambda b, _g=got: _g.append(tuple(rec(t) for t in b.tensors)))
        pipe.play()
        try:
            for p in pushes or ():
                pipe.get("in").push_buffer(p)
            if pushes is not None:
                pipe.get("in").end_of_stream()
            msg = pipe.wait(timeout=timeout)
        finally:
            pipe.stop()
        assert msg.type.name == "EOS", msg
        res.append((got, str(pipe.get("out").sinkpad.caps)))
    return res


@pytest.fixture(scope="module")
def scaler_so():
    return build_plugin(SCALER, "scaler")


@pytest.fixture(scope="module")
def offset_so():
    return build_plugin(OFFSET, "offset_cpp")


# -- the C ABI -------------------------------------------------------------

@pytest.mark.parametrize("header", ["nns_custom_filter.h",
                                    "nns_custom_filter.hh"])
def test_headers_are_byte_identical(header):
    with open(os.path.join(PORT_INCLUDE, header), "rb") as a, \
            open(os.path.join(REF_INCLUDE, header), "rb") as b:
        assert a.read() == b.read()


def test_dtype_codes_match_the_header():
    text = open(os.path.join(PORT_INCLUDE, "nns_custom_filter.h")).read()
    codes = {m.group(1).lower(): int(m.group(2)) for m in
             re.finditer(r"NNS_(\w+) = (\d+),", text)}
    assert sorted(codes.values()) == list(range(13))
    assert [d.value for d in custom_c._DTYPES] == \
        [name for name, _ in sorted(codes.items(), key=lambda kv: kv[1])]
    assert [d.value for d in custom_c._DTYPES] == \
        [d.value for d in jcustom_c._DTYPES]
    assert custom_c.ABI_VERSION == jcustom_c.ABI_VERSION == 1


def test_auto_detect_so_and_py_extensions(scaler_so):
    assert get_config().framework_priority(scaler_so) == ["custom"] == \
        jget_config().framework_priority(scaler_so)
    assert get_config().framework_priority("m.py") == ["python"]


def _open_pair(so, custom=""):
    j, t = jcustom_c.CustomCBackend(), custom_c.CustomCBackend()
    j.open(JProps(model=so, custom=custom))
    t.open(FilterProperties(model=so, custom=custom))
    return j, t


@pytest.mark.parametrize("dtype,custom", [("float32", "factor:2"),
                                          ("int32", "factor:3")])
def test_vtable_lifecycle_and_invoke(scaler_so, dtype, custom):
    j, t = _open_pair(scaler_so, custom)
    oj = j.set_input_info(JInfo.of(JSpec((2, 3), JDataType(dtype))))
    ot = t.set_input_info(TensorsInfo.of(TensorSpec((2, 3), dtype)))
    assert ot.specs[0].shape == oj.specs[0].shape == (2, 3)
    assert ot.specs[0].dtype.value == oj.specs[0].dtype.value == dtype
    x = np.random.default_rng(0).integers(-50, 50, (2, 3)).astype(dtype)
    assert rec(t.invoke([x])[0]) == rec(j.invoke([x])[0])
    t.close()
    j.close()
    assert t.props is None


def test_pipeline_auto_detect(scaler_so):
    line = ("tensor_src num-buffers=3 dimensions=4 types=float32 "
            f"pattern=counter ! tensor_filter framework=auto model={scaler_so} "
            "custom=factor:10 ! tensor_sink name=out")
    want, got = run_both(line)
    assert got == want
    assert got[0][2][0][2] == np.full(4, 20.0, np.float32).tobytes()


def test_abi_mismatch_rejected_naming_the_port_header():
    so = build_plugin(
        '#include <cstdint>\n'
        'extern "C" {\n'
        'int32_t nns_custom_abi_version() { return 999; }\n'
        'void* nns_custom_open(const char*) { return nullptr; }\n'
        'void nns_custom_close(void*) {}\n'
        'int nns_custom_invoke(void*, const void*, uint32_t, void*, uint32_t)'
        ' { return -1; }\n'
        'int nns_custom_get_info(void*, void*, void*) { return -1; }\n'
        '}\n', "bad_abi")
    with pytest.raises(RuntimeError, match="ABI") as port:
        custom_c.CustomCBackend().open(FilterProperties(model=so))
    with pytest.raises(RuntimeError, match="ABI"):
        jcustom_c.CustomCBackend().open(JProps(model=so))
    assert "nnstreamer_tpu_torch/native/csrc" in str(port.value)


def test_non_plugin_so_clear_error():
    so = build_plugin('extern "C" { int not_a_plugin() { return 0; } }\n',
                      "not_a_plugin")
    with pytest.raises(RuntimeError, match="missing symbols") as port:
        custom_c.CustomCBackend().open(FilterProperties(model=so))
    with pytest.raises(RuntimeError, match="missing symbols"):
        jcustom_c.CustomCBackend().open(JProps(model=so))
    assert "nnstreamer_tpu_torch/native/csrc/nns_custom_filter.h" in \
        str(port.value)


def test_lifecycle_guard_after_close(scaler_so):
    b = custom_c.CustomCBackend()
    b.open(FilterProperties(model=scaler_so, custom="factor:2"))
    b.close()
    with pytest.raises(RuntimeError, match="not open"):
        b.set_input_info(TensorsInfo.of(TensorSpec((2,), "float32")))
    with pytest.raises(RuntimeError, match="not open"):
        b.get_model_info()
    with pytest.raises(RuntimeError, match="not open"):
        b.invoke([np.zeros(2, np.float32)])


def test_accelerator_gpu_refused(scaler_so):
    from nnstreamer_tpu_torch.backends.base import Accelerator

    with pytest.raises(ValueError, match="accelerator=gpu"):
        custom_c.CustomCBackend().open(FilterProperties(
            model=scaler_so, accelerator=Accelerator.GPU))


# bfloat16 in and out: halves each value's bit pattern, and reports it as
# the low byte of an int32 second output
BF16_SRC = r"""
#include <cstring>
#include "nns_custom_filter.hh"

class HalfBits : public nns::CustomFilter {
 public:
  explicit HalfBits(const std::string &) {}
  bool set_input(const nns_tensors_spec *in, nns_tensors_spec *out) override {
    if (in->num != 1 || in->spec[0].dtype != NNS_BFLOAT16) return false;
    std::memset(out, 0, sizeof(*out));
    out->num = 2;
    out->spec[0] = in->spec[0];
    out->spec[1] = in->spec[0];
    out->spec[1].dtype = NNS_INT32;
    return true;
  }
  int invoke(const nns_tensor_view *in, uint32_t, nns_tensor_view *out,
             uint32_t) override {
    const uint16_t *s = static_cast<const uint16_t *>(in[0].data);
    uint16_t *d = static_cast<uint16_t *>(out[0].data);
    int32_t *lo = static_cast<int32_t *>(out[1].data);
    for (uint64_t i = 0; i < in[0].size / 2; ++i) {
      d[i] = (uint16_t)(s[i] - 0x80);   /* exponent - 1: half the value */
      lo[i] = s[i] & 0xff;
    }
    return 0;
  }
};
NNS_REGISTER_CUSTOM_FILTER(HalfBits)
"""


def test_bfloat16_input_and_output_spec():
    so = build_plugin(BF16_SRC, "half_bits")
    line = ("tensor_src num-buffers=3 dimensions=5:2 types=bfloat16 "
            f"pattern=random ! tensor_filter framework=custom model={so} "
            "! tensor_sink name=out")
    want, got = run_both(line)
    assert got[1] == want[1]
    # the random values differ between the packages; the plugin's
    # function of each package's own input is what must agree
    for (half, lo) in got[0]:
        assert half[0] == "bfloat16" and lo[0] == "int32"
    t = custom_c.CustomCBackend()
    t.open(FilterProperties(model=so))
    x = torch.tensor([[1.0, 2.0, -4.0], [0.5, 3.0, 8.0]], dtype=torch.bfloat16)
    half, lo = t.invoke([x])
    assert half.dtype is torch.bfloat16 and torch.equal(half, x / 2)
    assert lo.tolist() == (bf16_bits(x) & 0xFF).astype(np.int32).tolist()
    j = jcustom_c.CustomCBackend()
    j.open(JProps(model=so))
    import ml_dtypes

    jx = bf16_bits(x).view(ml_dtypes.bfloat16)
    jhalf, jlo = j.invoke([jx])
    assert rec(half) == rec(jhalf) and rec(lo) == rec(jlo)
    t.close()
    j.close()


# -- C++ classes (nns_custom_filter.hh) ------------------------------------

DYNAMIC_SRC = r"""
#include <cstring>
#include "nns_custom_filter.hh"

class Negate : public nns::CustomFilter {
 public:
  explicit Negate(const std::string &) {}
  bool set_input(const nns_tensors_spec *in, nns_tensors_spec *out) override {
    std::memcpy(out, in, sizeof(*out));
    return true;
  }
  int invoke(const nns_tensor_view *in, uint32_t n_in, nns_tensor_view *out,
             uint32_t n_out) override {
    if (n_in != 1 || n_out != 1) return -2;
    const float *s = static_cast<const float *>(in[0].data);
    float *d = static_cast<float *>(out[0].data);
    for (uint64_t i = 0; i < in[0].size / sizeof(float); ++i) d[i] = -s[i];
    return 0;
  }
};
NNS_REGISTER_CUSTOM_FILTER(Negate)
"""

THROWING_SRC = r"""
#include <stdexcept>
#include "nns_custom_filter.hh"

class Broken : public nns::CustomFilter {
 public:
  explicit Broken(const std::string &) { throw std::runtime_error("boom"); }
  int invoke(const nns_tensor_view *, uint32_t, nns_tensor_view *,
             uint32_t) override { return 0; }
  bool get_info(nns_tensors_spec *, nns_tensors_spec *) override {
    return true;
  }
};
NNS_REGISTER_CUSTOM_FILTER(Broken)
"""


def test_cpp_static_class_info_and_invoke(offset_so):
    j, t = _open_pair(offset_so, "offset:1.5")
    (ji, jo), (ti, to) = j.get_model_info(), t.get_model_info()
    assert ti.specs[0].shape == ji.specs[0].shape == (1, 4)
    assert to.specs[0].dtype is DataType.FLOAT32
    x = np.random.default_rng(1).standard_normal((1, 4)).astype(np.float32)
    assert rec(t.invoke([x])[0]) == rec(j.invoke([x])[0])
    np.testing.assert_array_equal(t.invoke([x])[0], x + np.float32(1.5))


def test_cpp_pipeline_end_to_end(offset_so):
    line = ("tensor_src num-buffers=2 dimensions=4:1 types=float32 "
            f"pattern=ones ! tensor_filter framework=custom model={offset_so} "
            "custom=offset:2.0 ! tensor_sink name=out")
    want, got = run_both(line)
    assert got == want
    assert got[0][0][0][2] == np.full((1, 4), 3.0, np.float32).tobytes()


def test_cpp_set_input_negotiates_any_shape():
    so = build_plugin(DYNAMIC_SRC, "negate_cpp")
    j, t = _open_pair(so)
    ot = t.set_input_info(TensorsInfo.of(TensorSpec((2, 3), "float32")))
    oj = j.set_input_info(JInfo.of(JSpec((2, 3), JDataType.FLOAT32)))
    assert ot.specs[0].shape == oj.specs[0].shape == (2, 3)
    x = np.random.default_rng(2).standard_normal((2, 3)).astype(np.float32)
    assert rec(t.invoke([x])[0]) == rec(j.invoke([x])[0])


def test_cpp_throwing_constructor_fails_open_cleanly():
    so = build_plugin(THROWING_SRC, "broken_cpp")
    with pytest.raises(RuntimeError, match="open failed"):
        custom_c.CustomCBackend().open(FilterProperties(model=so))
    with pytest.raises(RuntimeError, match="open failed"):
        jcustom_c.CustomCBackend().open(JProps(model=so))


# -- custom-easy and the repo RNN loop -------------------------------------

@pytest.fixture()
def rnn_cell():
    # the reference's dummyRNN role: next_state = (x + prev_state) / 2
    for mod in (jcustom_easy, custom_easy):
        mod.register_custom_easy(
            "avg_rnn", lambda t: [(np.asarray(t[0]) + np.asarray(t[1])) / 2.0])
    yield
    for mod in (jcustom_easy, custom_easy):
        mod.unregister_custom_easy("avg_rnn")


RNN_LINE = (
    "tensor_mux name=mux sync-mode=nosync "
    "! tensor_filter framework=custom-easy model=avg_rnn "
    "! tee name=t "
    "t. ! queue ! tensor_repo_sink slot-index={slot} "
    "t. ! queue ! tensor_sink name=out max-stored=0 "
    "tensor_src num-buffers={n} dimensions=4 types=float32 "
    "pattern=counter ! mux.sink_0 "
    "tensor_repo_src slot-index={slot} {dummy}"
    "caps=other/tensors,format=static,dimensions=4,types=float32 "
    "! mux.sink_1")


def _rnn(parse, repo, n, dummy, wait):
    repo.reset()
    pipe = parse(RNN_LINE.format(slot=31, n=n, dummy=dummy))
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    deadline = time.monotonic() + wait
    while len(got) < n and time.monotonic() < deadline:
        time.sleep(0.02)
    pipe.stop()
    return [rec(b.tensors[0]) for b in got[:n]]


def test_rnn_recurrence_matches_the_reference(rnn_cell):
    """h_k = (x_k + h_{k-1})/2 with h_{-1} = 0 and x_k = k, through the
    reference's RNN topology in both packages."""
    want = _rnn(jax_parse_launch, JREPO, 8, "initial-dummy=true ", 15)
    got = _rnn(parse_launch, REPO, 8, "initial-dummy=true ", 15)
    assert len(got) == 8 and got == want
    h = 0.0
    for k in range(8):
        h = (k + h) / 2.0
        assert got[k][0] == "float32"
        assert np.frombuffer(got[k][2], np.float32).tolist() == [h] * 4


def test_rnn_without_initial_dummy_stalls(rnn_cell):
    """The same loop minus initial-dummy deadlocks on frame 0 (the state
    never exists): the dummy is what bootstraps it."""
    REPO.reset()
    pipe = parse_launch(RNN_LINE.format(slot=32, n=4, dummy="timeout=0.5 "))
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    time.sleep(1.0)
    pipe.stop()
    assert len(got) == 0


def test_initial_dummy_requires_fixated_caps():
    from nnstreamer_tpu_torch.elements.repo import TensorRepoSrc

    REPO.reset()
    src = TensorRepoSrc(slot_index=33, initial_dummy=True,
                        caps="other/tensors,format=flexible")
    with pytest.raises(ValueError, match="fixated"):
        src._dummy_buffer()


@pytest.mark.parametrize("dtype", ["int16", "bfloat16"])
def test_dummy_is_zeros_with_declared_shape(dtype):
    from nnstreamer_tpu.elements.repo import TensorRepoSrc as JSrc
    from nnstreamer_tpu_torch.elements.repo import TensorRepoSrc

    caps = f"other/tensors,format=static,dimensions=2:3,types={dtype}"
    got = TensorRepoSrc(slot_index=34, initial_dummy=True, caps=caps)
    want = JSrc(slot_index=34, initial_dummy=True, caps=caps)
    a, b = got._dummy_buffer().tensors[0], want._dummy_buffer().tensors[0]
    assert rec(a) == rec(b) and rec(a)[1] == (3, 2)


def test_custom_easy_caps_from_a_probe_match_the_reference():
    fn = lambda t: [np.asarray(t[0]).sum(axis=-1).astype(np.int64)]  # noqa: E731
    for mod in (jcustom_easy, custom_easy):
        mod.register_custom_easy("rowsum", fn)
    try:
        want, got = run_both(
            "tensor_src num-buffers=2 dimensions=3:2 types=int32 "
            "pattern=counter ! tensor_filter framework=custom-easy "
            "model=rowsum ! tensor_sink name=out")
    finally:
        for mod in (jcustom_easy, custom_easy):
            mod.unregister_custom_easy("rowsum")
    assert got == want


def test_custom_easy_hands_out_no_fused_stage():
    info = TensorsInfo.of(TensorSpec((4,), "float32"))
    custom_easy.register_custom_easy("plus1", lambda t: [t[0] + 1], info, info)
    try:
        pipe = parse_launch(
            "tensor_src num-buffers=2 dimensions=4 types=float32 "
            "pattern=ones ! tensor_transform mode=arithmetic option=add:1 "
            "accelerator=cpu ! tensor_filter framework=custom-easy "
            "model=plus1 name=f ! tensor_sink name=out")
        got = []
        pipe.get("out").connect(got.append)
        pipe.run(timeout=30)
        assert pipe.get("f").backend is None or \
            pipe.get("f").backend.fusion_callable() is None
        assert [np.asarray(b.tensors[0]).tolist() for b in got] == \
            [[3.0] * 4] * 2
    finally:
        custom_easy.unregister_custom_easy("plus1")


def test_custom_easy_unknown_model_errors_on_the_bus():
    pipe = parse_launch("tensor_src num-buffers=1 dimensions=4 ! "
                        "tensor_filter framework=custom-easy model=ghost ! "
                        "tensor_sink name=out")
    pipe.play()
    msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=10)
    pipe.stop()
    assert msg is not None and "ghost" in msg.data["error"]


# -- the python backend ----------------------------------------------------

FLIP = ("import numpy as np\n"
        "class Filter:\n"
        "    seen = []\n"
        "    def invoke(self, inputs):\n"
        "        self.seen.append(type(inputs[0]).__name__)\n"
        "        return [np.flip(np.asarray(x), axis=-1) for x in inputs]\n")


@pytest.mark.parametrize("dtype", ["float32", "uint8", "int64"])
def test_python_filter_class_matches_the_reference(tmp_path, dtype):
    model = tmp_path / "pyfilter.py"
    model.write_text(FLIP)
    want, got = run_both(
        f"tensor_src num-buffers=2 dimensions=3:2 types={dtype} "
        f"pattern=counter ! tensor_filter framework=python model={model} "
        "! tensor_sink name=out")
    assert got == want


def test_python_filter_module_attr_and_alias(tmp_path):
    want, got = run_both(
        "tensor_src num-buffers=2 dimensions=4 types=float32 pattern=counter "
        "! tensor_filter framework=python3 model=numpy:negative "
        "! tensor_sink name=out")
    assert got == want


def test_python_filter_gets_bfloat16_as_a_cpu_tensor(tmp_path):
    model = tmp_path / "bf.py"
    model.write_text(
        "import torch\n"
        "class Filter:\n"
        "    def invoke(self, inputs):\n"
        "        x = inputs[0]\n"
        "        assert isinstance(x, torch.Tensor) and x.device.type == 'cpu'\n"
        "        return [x * 2]\n")
    pipe = parse_launch(
        "tensor_src num-buffers=2 dimensions=4 types=bfloat16 pattern=counter "
        f"! tensor_filter framework=python model={model} ! tensor_sink name=out")
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    msg = pipe.wait(timeout=30)
    pipe.stop()
    assert msg.type is MessageType.EOS, msg
    assert got[1].tensors[0].dtype is torch.bfloat16
    assert got[1].tensors[0].tolist() == [2.0] * 4
    assert "types=bfloat16" in str(pipe.get("out").sinkpad.caps)


def test_python_filter_refuses_accelerator_gpu(tmp_path):
    model = tmp_path / "pyfilter.py"
    model.write_text(FLIP)
    pipe = parse_launch(
        "tensor_src num-buffers=1 dimensions=3 types=float32 ! tensor_filter "
        f"framework=python accelerator=gpu model={model} ! tensor_sink")
    pipe.play()
    msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=10)
    pipe.stop()
    assert msg is not None and "accelerator=gpu" in msg.data["error"]


# -- the python3 converter and decoder -------------------------------------

NATIVE_CONVERTER = (
    "import numpy as np\n"
    "from {pkg}.core import Buffer, TensorsInfo\n"
    "from {pkg}.core.tensors import TensorSpec\n"
    "class Converter:\n"
    "    def get_out_info(self, in_caps):\n"
    "        return TensorsInfo.of(TensorSpec((4,), 'float32'))\n"
    "    def convert(self, buf):\n"
    "        raw = np.asarray(buf.tensors[0]).view(np.uint8)\n"
    "        return Buffer([raw[:4].astype(np.float32)])\n")

REFERENCE_CONVERTER = (
    "import numpy as np\n"
    "import nnstreamer_python as nns\n"
    "class CustomConverter(object):\n"
    "    def convert(self, input_array):\n"
    "        a = np.asarray(input_array[0]).view(np.uint8)\n"
    "        shape = nns.TensorShape([2, 2], np.{dtype})\n"
    "        n = 4 * np.dtype(np.{dtype}).itemsize\n"
    "        return ([shape], [a[:n].tobytes()], 30, 1)\n")


def _script_pair(tmp_path, template, **kw):
    paths = []
    for pkg in ("nnstreamer_tpu", "nnstreamer_tpu_torch"):
        p = tmp_path / f"{pkg}_script.py"
        p.write_text(template.format(pkg=pkg, **kw))
        paths.append(p)
    return paths


def _run_one(parse, line, pushes):
    pipe = parse(line)
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    try:
        for p in pushes:
            pipe.get("in").push_buffer(p)
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=30)
    finally:
        pipe.stop()
    assert msg.type.name == "EOS", msg
    return ([(tuple(rec(t) for t in b.tensors), b.meta.get("framerate"))
             for b in got], str(pipe.get("out").sinkpad.caps))


def _both_scripts(paths, line_fmt, pushes):
    return [_run_one(parse, line_fmt.format(script=p), pushes)
            for parse, p in zip((jax_parse_launch, parse_launch), paths)]


@pytest.mark.parametrize("spelling", ["subplugin=python3 subplugin-option=",
                                      "mode=custom-script:"])
def test_native_converter_matches_the_reference(tmp_path, spelling):
    paths = _script_pair(tmp_path, NATIVE_CONVERTER)
    pushes = [np.random.default_rng(3).integers(0, 255, 8).astype(np.uint8)]
    want, got = _both_scripts(
        paths, "appsrc name=in caps=application/octet-stream ! "
        f"tensor_converter {spelling}{{script}} ! tensor_sink name=out",
        pushes)
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "int16", "uint8"])
def test_reference_converter_matches_the_reference(tmp_path, dtype):
    paths = _script_pair(tmp_path, REFERENCE_CONVERTER, dtype=dtype)
    pushes = [np.random.default_rng(4).integers(0, 255, 16).astype(np.uint8)
              for _ in range(2)]
    want, got = _both_scripts(
        paths, "appsrc name=in caps=application/octet-stream ! "
        "tensor_converter mode=custom-script:{script} ! "
        "tensor_sink name=out", pushes)
    assert got == want and got[0][0][1] == (30, 1)


def test_reference_converter_bfloat16_shape(tmp_path):
    path = tmp_path / "conv.py"
    path.write_text(REFERENCE_CONVERTER.replace("np.{dtype}", "'bfloat16'")
                    .replace("np.dtype('bfloat16').itemsize", "2"))
    raw = np.array([0x3F80, 0x4000, 0xC040, 0x0000], np.uint16)
    got, _ = _run_one(parse_launch,
                      "appsrc name=in caps=application/octet-stream ! "
                      f"tensor_converter mode=custom-script:{path} ! "
                      "tensor_sink name=out", [raw.view(np.uint8)])
    assert got[0][0][0] == ("bfloat16", (2, 2), raw.tobytes())


def test_converter_unknown_mode_still_refused():
    with pytest.raises(Exception, match="unknown converter mode"):
        pipe = parse_launch("appsrc caps=application/octet-stream ! "
                            "tensor_converter mode=bogus:x ! tensor_sink")
        pipe.play()
        msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=10)
        pipe.stop()
        raise RuntimeError(msg.data["error"])


REFERENCE_DECODER = (
    "import numpy as np\n"
    "class CustomDecoder(object):\n"
    "    def getOutCaps(self):\n"
    "        return b'application/octet-stream'\n"
    "    def decode(self, raw_data, in_info, rate_n, rate_d):\n"
    "        dims = [s.getDims() for s in in_info]\n"
    "        names = [np.dtype(s.getType()).name for s in in_info]\n"
    "        head = repr((dims, names, rate_n, rate_d)).encode()\n"
    "        return head + b''.join(raw_data)\n")

NATIVE_DECODER = (
    "import numpy as np\n"
    "from {pkg}.core import Buffer, Caps\n"
    "class Decoder:\n"
    "    def init(self, options):\n"
    "        self.options = options\n"
    "    def get_out_caps(self, in_info):\n"
    "        return Caps.new('application/octet-stream')\n"
    "    def decode(self, buf, in_info):\n"
    "        a = np.asarray(buf.tensors[0])\n"
    "        return Buffer([np.frombuffer((a * 3).tobytes(), np.uint8)])\n")


@pytest.mark.parametrize("template", [REFERENCE_DECODER, NATIVE_DECODER],
                         ids=["reference_api", "native_api"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "uint8"])
def test_python3_decoder_matches_the_reference(tmp_path, template, dtype):
    paths = _script_pair(tmp_path, template)
    rng = np.random.default_rng(5)
    pushes = [rng.integers(0, 100, (2, 3)).astype(dtype) for _ in range(3)]
    want, got = _both_scripts(
        paths, "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions=3:2,types={dtype} ! tensor_decoder mode=python3 "
        "option1={script} ! tensor_sink name=out", pushes)
    assert got == want


def test_python3_decoder_on_bfloat16_matches_the_reference(tmp_path):
    """A bfloat16 shape's type is ``torch.bfloat16`` in the port (numpy
    has none) and ``ml_dtypes``' in nnstreamer_tpu, so the script names
    it the way that reads both."""
    import ml_dtypes

    paths = _script_pair(tmp_path, REFERENCE_DECODER.replace(
        "np.dtype(s.getType()).name",
        "getattr(s.getType(), 'name', None) "
        "or str(s.getType()).split('.')[-1]"))
    bits = np.random.default_rng(6).integers(0x3F00, 0x4100, (2, 3)) \
        .astype(np.uint16)
    res = []
    for parse, p, x in zip(
            (jax_parse_launch, parse_launch), paths,
            (bits.view(ml_dtypes.bfloat16),
             torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16))):
        res.append(_run_one(
            parse, "appsrc name=in caps=other/tensors,format=static,"
            "dimensions=3:2,types=bfloat16 ! tensor_decoder mode=python3 "
            f"option1={p} ! tensor_sink name=out", [x]))
    assert res[1] == res[0]
    assert res[1][0][0][0][0][2].endswith(bits.tobytes())


# -- the nnstreamer_python shim --------------------------------------------

def test_tensor_shape_shim():
    from nnstreamer_tpu.compat.nnstreamer_python import TensorShape as JShape
    from nnstreamer_tpu_torch.compat import install_nnstreamer_python
    from nnstreamer_tpu_torch.compat.nnstreamer_python import TensorShape

    for dims, dtype in (([3, 224, 224, 1], np.float32), (range(20), "uint8")):
        a, b = TensorShape(dims, dtype), JShape(dims, dtype)
        assert a.getDims() == b.getDims() and a.getType() == b.getType()
    s = TensorShape([2], "bfloat16")
    assert s.getType() is torch.bfloat16
    s.setType(np.int8)
    assert s.getType() == np.dtype(np.int8)
    import ml_dtypes

    assert TensorShape([1], ml_dtypes.bfloat16).getType() is torch.bfloat16
    install_nnstreamer_python()
    import sys

    assert "nnstreamer_python" in sys.modules
