"""Transport and query on the card (marker ``cuda``; skips without a card).
This file needs neither JAX nor nnstreamer_tpu:

    python -m pytest --noconftest -q -m cuda tests/test_torch_query_cuda.py

Phase 17 of chip_smoke.py in small form:

* card tensors are encoded with one device→host copy each (counted in the
  wire stats), NNSB and NNST frames of a card tensor equal its host
  copy's;
* bfloat16 card tensors cross the shm ring byte-exact;
* a query server in its own process serves the ``tiny`` LM entry on the
  card: the tokens equal the in-process filter line's, every prefill and
  decode step of the server went through the kernels, and the link is
  NNSB with shm;
* with ``grpc`` blocked, ``tensor_sink_grpc`` posts a bus ERROR naming
  grpc;
* the fake-quant conv orders' kernel (``csrc/fma_gemm.cu``) equals its
  plain version bit for bit."""
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch import transport
from nnstreamer_tpu_torch.core import Buffer
from nnstreamer_tpu_torch.core.serialize import pack_tensors, unpack_tensors
from nnstreamer_tpu_torch.runtime.parse import parse_launch

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card"),
]

ROOT = Path(__file__).resolve().parents[1]
DEV = torch.device("cuda:0")


def _host(t) -> bytes:
    """The bytes of a card or CPU tensor (bfloat16 by its bit patterns)
    or of a numpy array (what a decode gives for other dtypes)."""
    if not isinstance(t, torch.Tensor):
        return np.ascontiguousarray(t).tobytes()
    t = t.detach().cpu().contiguous()
    if t.dtype is torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32, torch.uint8])
def test_card_tensors_encode_with_one_copy_each(dtype):
    g = torch.Generator(device=DEV).manual_seed(0)
    t = (torch.randn(4, 33, device=DEV, generator=g) * 50).to(dtype)
    u = (torch.randn(7, device=DEV, generator=g) * 50).to(dtype)
    transport.stats.reset()
    frame = bytes(transport.encode_frame_bytes(Buffer([t, u])))
    d2h = transport.stats.snapshot()["d2h"]
    assert d2h == {"tensors": 2,
                   "bytes": (t.numel() + u.numel()) * t.element_size()}
    assert frame == bytes(transport.encode_frame_bytes(
        Buffer([t.cpu(), u.cpu()])))
    out = transport.decode_frame(frame)
    assert _host(out.tensors[0]) == _host(t)
    back = unpack_tensors(pack_tensors(Buffer([t])))
    assert _host(back.tensors[0]) == _host(t)


def test_bfloat16_card_tensor_over_shm_is_byte_exact():
    g = torch.Generator(device=DEV).manual_seed(1)
    t = torch.randn(64, 1001, device=DEV, generator=g).to(torch.bfloat16)
    ring = transport.create_ring(slots=2)  # pairs-with: detach_ring
    reader = transport.attach_ring(ring.name)  # pairs-with: detach_ring
    try:
        desc = ring.write_frame(transport.encode_frame(Buffer([t])))
        out = reader.read_frame(*transport.unpack_descriptor(desc)[1:])
        assert out.tensors[0].dtype is torch.bfloat16
        assert _host(out.tensors[0]) == _host(t)
    finally:
        transport.detach_ring(reader)
        transport.detach_ring(ring)


CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.modules["jax"] = None
sys.modules["nnstreamer_tpu"] = None
import torch
from nnstreamer_tpu_torch.ops.decode_attention import decode_attention
from nnstreamer_tpu_torch.ops.flash_attention import flash_attention
from nnstreamer_tpu_torch.runtime.parse import parse_launch
pipe = parse_launch(sys.argv[2])
pipe.play()
print(json.dumps({"port": pipe.get("ssrc").bound_port}), flush=True)
sys.stdin.readline()
pipe.stop()
torch.cuda.synchronize()
print(json.dumps({"decode": decode_attention.launches,
                  "flash": flash_attention.launches}), flush=True)
"""
CAPS = "other/tensors,format=static,dimensions=6:4,types=int32"
MODEL = "nnstreamer_tpu_torch.models.lm_serving:tiny"


def _line(proc, timeout=300):
    got = {}
    t = threading.Thread(
        target=lambda: got.update(line=proc.stdout.readline()), daemon=True)
    t.start()
    t.join(timeout)
    assert got.get("line"), "the server process printed nothing"
    return json.loads(got["line"])


def _serve(line_of_client, prompts):
    pipe = parse_launch(line_of_client)
    outs = []
    pipe.get("out").connect(outs.append)
    pipe.play()
    try:
        for p in prompts:
            pipe.get("in").push_buffer(p)
        deadline = time.monotonic() + 300
        while len(outs) < len(prompts) and time.monotonic() < deadline:
            time.sleep(0.01)
        qc = pipe.get("qc") if "name=qc" in line_of_client else None
        info = (qc.client.wire_format, qc.client.shm_active) if qc else None
    finally:
        pipe.stop()
    return [o.as_numpy().tensors[0] for o in outs], info


def test_lm_server_in_a_child_process_through_the_kernels():
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 64, (4, 6)).astype(np.int32)
               for _ in range(2)]
    server = (f"tensor_query_serversrc name=ssrc id=0 port=0 caps={CAPS} "
              f"! tensor_filter framework=torch model={MODEL} "
              "! tensor_query_serversink id=0")
    proc = subprocess.Popen([sys.executable, "-c", CHILD, str(ROOT), server],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, env={**os.environ,
                                            "PYTHONPATH": str(ROOT)})
    try:
        port = _line(proc)["port"]
        got, info = _serve(
            f"appsrc name=in caps={CAPS} ! tensor_query_client name=qc "
            f"port={port} timeout=300 ! tensor_sink name=out", prompts)
        proc.stdin.close()
        counts = _line(proc)
        assert proc.wait(timeout=120) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert info == ("binary", True)
    from nnstreamer_tpu_torch.models.lm_serving import tiny

    layers = tiny.cfg.layers
    steps = tiny.default_steps
    assert counts["flash"] == len(prompts) * layers
    assert counts["decode"] == len(prompts) * layers * (steps - 1)
    want, _ = _serve(f"appsrc name=in caps={CAPS} ! tensor_filter "
                     f"framework=torch model={MODEL} ! tensor_sink name=out",
                     prompts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_grpc_blocked_is_a_typed_error():
    code = """
import sys
sys.modules["grpc"] = None
sys.modules["jax"] = None
sys.modules["nnstreamer_tpu"] = None
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.runtime.parse import parse_launch
p = parse_launch("tensor_src num-buffers=2 dimensions=4 types=float32 "
                 "device=true ! tensor_sink_grpc server=false port=1")
p.play()
m = p.bus.wait_for((MessageType.ERROR,), timeout=60)
p.stop()
assert m is not None and "grpc" in m.data["error"], m
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# both tile shapes (N <= 32 and wider), ragged M, N and K edges, N not a
# multiple of 4 (scalar stores), K of one step and of several
@pytest.mark.parametrize("m,k,n", [(1000, 27, 32), (37, 320, 1280), (5, 1, 3),
                                   (257, 33, 33), (300, 65, 70),
                                   (129, 384, 64), (513, 96, 31)])
def test_fma_gemm_kernel_equals_its_plain_version(m, k, n):
    from nnstreamer_tpu_torch.ops.fma_gemm import fma_gemm, fma_gemm_plain

    g = torch.Generator(device=DEV).manual_seed(m + k + n)
    a = torch.randn(m, k, device=DEV, generator=g)
    b = torch.randn(k, n, device=DEV, generator=g)
    before = fma_gemm.launches
    got = fma_gemm(a, b)
    assert fma_gemm.launches == before + 1
    assert torch.equal(got, fma_gemm_plain(a, b))
    assert torch.equal(got.cpu(), fma_gemm(a.cpu(), b.cpu()))


# the other orders (two or four chains, blocks of K): ragged chains and
# blocks, both tile shapes
@pytest.mark.parametrize("m,k,n,chains,kblock", [
    (1000, 27, 32, 2, 0), (513, 96, 31, 4, 0), (300, 65, 70, 2, 0),
    (129, 384, 64, 4, 0), (5, 3, 3, 4, 0), (37, 960, 320, 1, 512),
    (257, 1100, 33, 1, 512), (64, 512, 16, 1, 512)])
def test_fma_gemm_orders_equal_their_plain_version(m, k, n, chains, kblock):
    from nnstreamer_tpu_torch.ops.fma_gemm import fma_gemm, fma_gemm_plain

    g = torch.Generator(device=DEV).manual_seed(m + k + n + chains)
    a = torch.randn(m, k, device=DEV, generator=g)
    b = torch.randn(k, n, device=DEV, generator=g)
    got = fma_gemm(a, b, chains, kblock)
    assert torch.equal(got, fma_gemm_plain(a, b, chains, kblock))
    assert torch.equal(got.cpu(), fma_gemm(a.cpu(), b.cpu(), chains, kblock))


# a strided view as ``a``: a channel slice of an NHWC tensor (rows of
# stride C > K) and a slice of every other column, in each order
@pytest.mark.parametrize("chains,kblock", [(1, 0), (2, 0), (4, 0), (1, 512)])
@pytest.mark.parametrize("view", ["channels", "every_other"])
def test_fma_gemm_reads_a_strided_view_as_its_values(view, chains, kblock):
    from nnstreamer_tpu_torch.ops.fma_gemm import fma_gemm, fma_gemm_plain

    g = torch.Generator(device=DEV).manual_seed(chains + kblock)
    k, n = 600, 40
    if view == "channels":
        wide = torch.randn(2, 9, 11, k + 24, device=DEV, generator=g)
        a = wide[..., 8:8 + k]
    else:
        wide = torch.randn(70, 2 * k, device=DEV, generator=g)
        a = wide[:, ::2]
    assert not a.is_contiguous()
    b = torch.randn(k, n, device=DEV, generator=g)
    before = fma_gemm.launches
    got = fma_gemm(a, b, chains, kblock)
    assert fma_gemm.launches == before + 1
    assert torch.equal(got, fma_gemm_plain(a.contiguous(), b, chains, kblock))
    assert torch.equal(got.cpu(),
                       fma_gemm(a.cpu(), b.cpu(), chains, kblock))
