"""The python, custom-easy and custom C filter backends, the python3
decoder and queue C's bfloat16 lines on the card (marker ``cuda``; skips
without a card). This file needs neither JAX nor nnstreamer_tpu:

    python -m pytest --noconftest -q -m cuda tests/test_torch_plugins_cuda.py

* custom-easy moves nothing: a registered callable gets the card tensors
  of ``tensor_src device=true`` and its outputs stay on cuda:0;
* ``framework=python`` gets host numpy (bfloat16: a CPU torch tensor)
  after one explicit pull a card tensor, and ``accelerator=gpu`` is
  refused on the bus;
* a reference-style ``mode=python3`` decoder gets a card tensor's bytes;
* a g++-built custom C plugin takes a card tensor through one pull and
  gives host outputs, a bfloat16 output spec included;
* tensor_crop and the sparse codecs on card bfloat16 give the CPU run's
  bytes."""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch.backends.custom_easy import (register_custom_easy,
                                                       unregister_custom_easy)
from nnstreamer_tpu_torch.core import MessageType, TensorsInfo
from nnstreamer_tpu_torch.core.buffer import bf16_bits
from nnstreamer_tpu_torch.core.tensors import TensorSpec
from nnstreamer_tpu_torch.runtime.parse import parse_launch

HEADER_DIR = str(Path(__file__).resolve().parent.parent
                 / "nnstreamer_tpu_torch" / "native" / "csrc")

# per-row argmax (int32) and row maximum (bfloat16) of (rows, cols) float32
PLUGIN = r"""
#include <cstring>
#include <string>
#include "nns_custom_filter.hh"

static uint16_t to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof(u));
  u += 0x7fffu + ((u >> 16) & 1u);
  return (uint16_t)(u >> 16);
}

class RowMax : public nns::CustomFilter {
 public:
  explicit RowMax(const std::string &) {}
  bool set_input(const nns_tensors_spec *in, nns_tensors_spec *out) override {
    if (in->num != 1 || in->spec[0].dtype != NNS_FLOAT32 ||
        in->spec[0].rank != 2) return false;
    rows_ = in->spec[0].dims[0];
    cols_ = in->spec[0].dims[1];
    std::memset(out, 0, sizeof(*out));
    out->num = 2;
    out->spec[0].dtype = NNS_INT32;
    out->spec[0].rank = 1;
    out->spec[0].dims[0] = rows_;
    out->spec[1].dtype = NNS_BFLOAT16;
    out->spec[1].rank = 1;
    out->spec[1].dims[0] = rows_;
    return true;
  }
  int invoke(const nns_tensor_view *in, uint32_t, nns_tensor_view *out,
             uint32_t) override {
    const float *x = static_cast<const float *>(in[0].data);
    int32_t *arg = static_cast<int32_t *>(out[0].data);
    uint16_t *mx = static_cast<uint16_t *>(out[1].data);
    for (int64_t r = 0; r < rows_; ++r) {
      int64_t best = 0;
      for (int64_t c = 1; c < cols_; ++c)
        if (x[r * cols_ + c] > x[r * cols_ + best]) best = c;
      arg[r] = (int32_t)best;
      mx[r] = to_bf16(x[r * cols_ + best]);
    }
    return 0;
  }
 private:
  int64_t rows_ = 0, cols_ = 0;
};
NNS_REGISTER_CUSTOM_FILTER(RowMax)
"""


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _collect(line, name="out"):
    pipe = parse_launch(line)
    got = []
    pipe.get(name).connect(got.append)
    pipe.play()
    try:
        msg = pipe.wait(timeout=120)
    finally:
        pipe.stop()
    return pipe, msg, got


def _rec(t):
    if isinstance(t, torch.Tensor) and t.dtype is torch.bfloat16:
        return ("bfloat16", tuple(t.shape), bf16_bits(t).tobytes())
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    a = np.ascontiguousarray(t)
    return (a.dtype.name, a.shape, a.tobytes())


@pytest.mark.cuda
def test_custom_easy_keeps_card_tensors_on_the_card(cuda_card):
    seen = []

    def double(ts):
        seen.append(ts[0].device)
        return [ts[0] * 2]

    info = TensorsInfo.of(TensorSpec((2, 4), "float32"))
    register_custom_easy("double_card", double, info, info)
    try:
        pipe, msg, got = _collect(
            "tensor_src device=true num-buffers=3 dimensions=4:2 "
            "types=float32 pattern=counter ! tensor_filter "
            "framework=custom-easy model=double_card ! tensor_sink name=out")
    finally:
        unregister_custom_easy("double_card")
    assert msg.type is MessageType.EOS, msg
    assert set(seen) == {cuda_card}
    assert [b.tensors[0].device for b in got] == [cuda_card] * 3
    assert torch.equal(got[2].tensors[0].cpu(), torch.full((2, 4), 4.0))


@pytest.mark.cuda
def test_python_filter_gets_host_arrays_pulled_once(cuda_card, tmp_path):
    script = tmp_path / "f.py"
    script.write_text(
        "import numpy as np\n"
        "class Filter:\n"
        "    seen = []\n"
        "    def invoke(self, inputs):\n"
        "        self.seen.append(type(inputs[0]).__name__)\n"
        "        return [np.asarray(inputs[0]) + 1]\n")
    pipe, msg, got = _collect(
        "tensor_src device=true num-buffers=3 dimensions=4:2 types=float32 "
        f"pattern=counter ! tensor_filter framework=python model={script} "
        "name=f ! tensor_sink name=out")
    assert msg.type is MessageType.EOS, msg
    assert isinstance(got[1].tensors[0], np.ndarray)
    assert np.array_equal(got[1].tensors[0], np.full((2, 4), 2.0, np.float32))
    _, msg, _ = _collect(
        "tensor_src num-buffers=1 dimensions=4 types=float32 ! tensor_filter "
        f"framework=python accelerator=gpu model={script} ! tensor_sink "
        "name=out")
    assert msg.type is MessageType.ERROR
    assert "accelerator=gpu" in msg.data["error"]


@pytest.mark.cuda
def test_python_backend_counts_its_pulls(cuda_card, tmp_path):
    from nnstreamer_tpu_torch.backends.base import FilterProperties
    from nnstreamer_tpu_torch.backends.python_backend import PythonBackend

    script = tmp_path / "f.py"
    script.write_text("class Filter:\n"
                      "    def invoke(self, inputs):\n"
                      "        return list(inputs)\n")
    b = PythonBackend()
    b.open(FilterProperties(model=str(script)))
    x = torch.arange(4, dtype=torch.bfloat16, device=cuda_card)
    (y,) = b.invoke([x])
    assert y.device.type == "cpu" and y.dtype is torch.bfloat16
    assert torch.equal(y, x.cpu()) and b.host_pulls == 1
    b.close()


@pytest.mark.cuda
def test_python3_decoder_gets_card_tensor_bytes(cuda_card, tmp_path):
    dec = tmp_path / "d.py"
    dec.write_text(
        "class CustomDecoder(object):\n"
        "    def getOutCaps(self):\n"
        "        return b'application/octet-stream'\n"
        "    def decode(self, raw_data, in_info, rate_n, rate_d):\n"
        "        return raw_data[0]\n")
    _, msg, got = _collect(
        "tensor_src device=true num-buffers=2 dimensions=4:2 types=bfloat16 "
        f"pattern=counter ! tensor_decoder mode=python3 option1={dec} ! "
        "tensor_sink name=out")
    assert msg.type is MessageType.EOS, msg
    want = bf16_bits(torch.full((2, 4), 1.0, dtype=torch.bfloat16)).tobytes()
    assert np.asarray(got[1].tensors[0]).tobytes() == want


@pytest.mark.cuda
def test_custom_c_plugin_on_card_logits(cuda_card, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    src, so = tmp_path / "rowmax.cc", tmp_path / "librowmax.so"
    src.write_text(PLUGIN)
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-I",
                    HEADER_DIR, "-o", str(so), str(src)], check=True,
                   capture_output=True)
    _, msg, got = _collect(
        "tensor_src device=true num-buffers=2 dimensions=16:4 types=float32 "
        f"pattern=random ! tee name=t t. ! queue ! tensor_filter "
        f"framework=custom model={so} ! tensor_sink name=out "
        "t. ! queue ! tensor_sink name=src")
    assert msg.type is MessageType.EOS, msg
    for buf in got:
        arg, mx = buf.tensors
        assert isinstance(arg, np.ndarray) and arg.dtype == np.int32
        assert mx.dtype is torch.bfloat16 and mx.device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("line", [
    "tensor_crop name=c ! tensor_sink name=out tensor_src device=true "
    "{acc}num-buffers=2 dimensions=3:8:8:1 types=bfloat16 pattern=counter "
    "! c.raw tensor_src num-buffers=2 dimensions=4:1 types=uint32 "
    "pattern=ones ! c.info",
    "tensor_src device=true {acc}num-buffers=3 dimensions=4:2 "
    "types=bfloat16 pattern=counter ! tensor_sparse_enc ! "
    "tensor_sparse_dec ! tensor_sink name=out",
], ids=["crop", "sparse"])
def test_queue_c_lines_on_card_bfloat16(cuda_card, line):
    runs = []
    for acc in ("", "accelerator=cpu "):
        _, msg, got = _collect(line.format(acc=acc))
        assert msg.type is MessageType.EOS, msg
        runs.append([tuple(_rec(t) for t in b.tensors) for b in got])
    assert runs[0] and runs[0] == runs[1]
