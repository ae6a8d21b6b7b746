"""Queue C: the five stream elements that failed on host bfloat16
(tensor_merge, tensor_if's fill-zero and fill-values, the sparse codecs,
tensor_crop, tensor_repo_src initial-dummy), held against nnstreamer_tpu.

Every launch line runs through both packages — nnstreamer_tpu on its
``ml_dtypes`` bfloat16 arrays, the port on CPU ``torch.bfloat16`` tensors
— and is compared exactly, per sink: every buffer's tensors as (dtype,
shape, bytes), a bfloat16 tensor's bytes through a uint16 view on both
sides, then the caps strings of the CAPS events and EOS last. The float32
forms of the same lines are held the same way, so the fixes leave them
as they were."""
import time

import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements.repo import REPO as JREPO
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.core.buffer import bf16_bits
from nnstreamer_tpu_torch.elements.repo import REPO
from nnstreamer_tpu_torch.runtime.parse import parse_launch


def SRC(d, dtype, n=3):
    return (f"tensor_src num-buffers={n} dimensions={d} types={dtype} "
            "pattern=counter")


LINES = {
    "merge": lambda t: (f"tensor_merge name=m mode=linear option=0 ! "
                        f"tensor_sink name=out {SRC('4:2', t)} ! m.sink_0 "
                        f"{SRC('4:2', t)} ! m.sink_1"),
    "if_fill_zero": lambda t: (
        f"{SRC('2', t)} ! tensor_if compared-value=a-value operator=lt "
        "supplied-value=1 then=passthrough else=fill-zero ! "
        "tensor_sink name=out"),
    "if_fill_values": lambda t: (
        f"{SRC('2', t)} ! tensor_if compared-value=a-value operator=lt "
        "supplied-value=1 then=passthrough else=fill-values else-option=3 "
        "! tensor_sink name=out"),
    "sparse_round_trip": lambda t: (
        f"{SRC('4:2', t)} ! tensor_sparse_enc ! tensor_sparse_dec ! "
        "tensor_sink name=out"),
    "sparse_enc": lambda t: (f"{SRC('4:2', t)} ! tensor_sparse_enc ! "
                             "tensor_sink name=out"),
    "crop": lambda t: (
        "tensor_crop name=c ! tensor_sink name=out tensor_src "
        f"num-buffers=2 dimensions=3:8:8:1 types={t} pattern=counter ! "
        "c.raw tensor_src num-buffers=2 dimensions=4:1 types=uint32 "
        "pattern=ones ! c.info"),
}


def _rec(t):
    """(dtype, shape, bytes); bfloat16 through its uint16 bit patterns."""
    if isinstance(t, torch.Tensor):
        if t.dtype is torch.bfloat16:
            return ("bfloat16", tuple(t.shape), bf16_bits(t).tobytes())
        t = t.cpu().numpy()
    a = np.ascontiguousarray(np.asarray(t))
    if a.dtype.name == "bfloat16":        # nnstreamer_tpu's ml_dtypes
        return ("bfloat16", a.shape, a.view(np.uint16).tobytes())
    return (a.dtype.name, a.shape, a.tobytes())


def _probe(pipe):
    seq = []
    el = pipe.get("out")

    def render(buf):
        seq.append(("buf", tuple(_rec(t) for t in buf.tensors)))
        type(el).render(el, buf)

    def hse(pad, event):
        caps = event.data.get("caps") if event.data else None
        seq.append(("event", event.type.name,
                    str(caps) if caps is not None else ""))
        type(el).handle_sink_event(el, pad, event)

    el.render = render
    el.handle_sink_event = hse
    return seq


def _run(parse, line, timeout=30):
    pipe = parse(line)
    seq = _probe(pipe)
    pipe.play()
    try:
        msg = pipe.wait(timeout=timeout)
    finally:
        pipe.stop()
    return msg.type.name, seq


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(LINES))
def test_line_matches_the_reference(name, dtype):
    line = LINES[name](dtype)
    want = _run(jax_parse_launch, line)
    got = _run(parse_launch, line)
    assert got[0] == "EOS" and want[0] == "EOS"
    assert got == want
    bufs = [e for e in got[1] if e[0] == "buf"]
    assert bufs and all(r[0] == dtype for e in bufs for r in e[1]
                        if r[0] != "int32")


def test_sparse_encoder_keeps_an_int32_index():
    _, seq = _run(parse_launch, LINES["sparse_enc"]("bfloat16"))
    recs = [e[1] for e in seq if e[0] == "buf"]
    assert [[r[0] for r in b] for b in recs] == [["int32", "bfloat16"]] * 3


def _repo_run(parse, repo, dtype):
    repo.reset()
    parse(f"{SRC('2', dtype)} ! tensor_repo_sink slot-index=7").run(timeout=30)
    pipe = parse("tensor_repo_src slot-index=7 initial-dummy=true "
                 f"caps=other/tensors,format=static,dimensions=2,types={dtype} "
                 "! tensor_sink name=out")
    seq = _probe(pipe)
    pipe.play()
    deadline = time.monotonic() + 10
    while sum(e[0] == "buf" for e in seq) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)   # room for a buffer too many
    pipe.stop()
    return [e for e in seq if e[0] == "buf"]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_repo_initial_dummy_matches_the_reference(dtype):
    want = _repo_run(jax_parse_launch, JREPO, dtype)
    got = _repo_run(parse_launch, REPO, dtype)
    assert len(got) == 3 and got == want
    assert got[0][1][0][2] == bytes(2 * np.dtype(
        np.uint16 if dtype == "bfloat16" else np.float32).itemsize)


def test_if_fill_with_file_on_bfloat16(tmp_path):
    """The fill-from-file action's host path shares the bfloat16 repair:
    the file's bytes land as the tensor's bit patterns."""
    raw = tmp_path / "fill.raw"
    raw.write_bytes(np.array([0x3F80, 0x4000], np.uint16).tobytes())
    line = (f"{SRC('2', 'bfloat16', 1)} ! tensor_if compared-value=a-value "
            "operator=gt supplied-value=100 then=passthrough "
            f"else=fill-with-file else-option={raw} ! tensor_sink name=out")
    want = _run(jax_parse_launch, line)
    got = _run(parse_launch, line)
    assert got == want and got[0] == "EOS"
    b = [e for e in got[1] if e[0] == "buf"][0][1][0]
    assert np.frombuffer(b[2], np.uint16).tolist() == [0x3F80, 0x4000]
