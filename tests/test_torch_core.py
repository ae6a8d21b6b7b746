"""The port's data model against nnstreamer_tpu's: the same caps strings and
tensor specs parse to the same results in both packages, and the port's
Buffer treats CUDA-side tensors as device-resident."""
import numpy as np
import pytest
import torch

import nnstreamer_tpu.core as ref
import nnstreamer_tpu_torch.core as port

CAPS_STRINGS = [
    "other/tensors,format=static,dimensions=3:224:224:1,types=uint8,framerate=30/1",
    "other/tensors,format=static,num_tensors=2,dimensions=3:224:224:1.10:1,"
    "types=uint8.float32",
    "other/tensors,format=flexible",
    "video/raw,format={RGB,GRAY8},width=[16,4096]",
    "video/x-raw, width=160, height=120",
    "other/tensor,dimension=4:2,type=bfloat16",
    "other/tensors,format=static,dimensions=512:8,types=int32",
]


def _info_tuple(info):
    return (info.format.value,
            tuple((s.shape, s.dtype.value, s.name) for s in info.specs))


@pytest.mark.parametrize("text", CAPS_STRINGS)
def test_caps_strings_parse_alike(text):
    a, b = ref.parse_caps_string(text), port.parse_caps_string(text)
    assert str(a) == str(b)
    assert a.is_fixed == b.is_fixed
    assert str(a.fixate()) == str(b.fixate())
    if a.first.media_type == ref.TENSORS_MIME:
        assert _info_tuple(ref.tensors_info_from_caps(a)) == \
            _info_tuple(port.tensors_info_from_caps(b))


@pytest.mark.parametrize("dims,types", [
    ("3:224:224:1", "uint8"), ("10:1", "float32"), ("512:8", "int32"),
    ("4:2", "bfloat16"), ("1", "float16")])
def test_tensors_info_alike(dims, types):
    a = ref.TensorSpec.from_dim_string(dims, types)
    b = port.TensorSpec.from_dim_string(dims, types)
    assert (a.shape, a.dtype.value, a.nbytes, a.to_dim_string()) == \
        (b.shape, b.dtype.value, b.nbytes, b.to_dim_string())
    fa = ref.TensorsInfo.of(a).to_fields()
    fb = port.TensorsInfo.of(b).to_fields()
    assert fa == fb
    assert _info_tuple(ref.TensorsInfo.from_fields(fa)) == \
        _info_tuple(port.TensorsInfo.from_fields(fb))


def test_caps_intersection_alike():
    for mod in (ref, port):
        a = mod.Caps.new("video/raw", width=mod.IntRange(1, 4096),
                         format=mod.ValueList(("RGB", "GRAY8")))
        b = mod.Caps.new("video/raw", width=640, format="RGB")
        i = a.intersect(b)
        assert i.is_fixed and i.first.get("width") == 640
        assert mod.Caps.new("other/tensors", format="static").intersect(
            mod.Caps.new("other/tensors", format="flexible")).is_empty


def test_datatype_maps_torch_dtypes():
    for dt in port.DataType:
        assert port.DataType.from_any(dt.torch_dtype) is dt
        assert dt.itemsize == ref.DataType(dt.value).itemsize
    assert port.DataType.BFLOAT16.torch_dtype is torch.bfloat16
    with pytest.raises(TypeError):
        port.DataType.BFLOAT16.np_dtype
    # nnstreamer_tpu's bfloat16 numpy arrays resolve by their dtype name
    a = np.zeros(3, ref.DataType.BFLOAT16.np_dtype)
    assert port.DataType.from_any(a.dtype) is port.DataType.BFLOAT16


def test_spec_matches_torch_tensors():
    s = port.TensorSpec((2, 3), "int32")
    assert s.matches(torch.zeros(2, 3, dtype=torch.int32))
    assert not s.matches(torch.zeros(2, 3, dtype=torch.int64))
    info = port.TensorsInfo.from_arrays([torch.zeros(4, dtype=torch.bfloat16)])
    assert info.specs[0].dtype is port.DataType.BFLOAT16


def test_buffer_host_and_device():
    host = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = torch.ones(4, dtype=torch.int32)
    b = port.Buffer.of(host, t, pts=1.5)
    assert not b.on_device                 # CPU tensors and ndarrays are host
    assert b.nbytes == 24 + 16
    assert b.as_numpy() is b               # nothing to pull: zero-copy
    assert b.as_numpy().tensors[0] is host
    assert b.spec().specs[1].dtype is port.DataType.INT32
    meta = torch.empty(2, 2, device="meta")   # any non-CPU tensor is device-side
    d = port.Buffer.of(meta)
    assert d.on_device
