"""The AOT plane on the card (marker ``cuda``; skips without a card). This
file needs neither JAX nor nnstreamer_tpu, so it runs where they are not
installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_aot_cuda.py

* each hand kernel as an ``nns::`` op: exported on the card, saved,
  loaded in a fresh interpreter; the loaded program launches the kernel
  (its counter moves) and gives the direct call's bits;
* a fused device segment exports, a second pipeline hits, and both serve
  the live line's bytes through one CUDA graph over the loaded module;
* a ``framework=torch-export`` filter exported for the card refuses to
  open for the CPU.
"""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch import aot
from nnstreamer_tpu_torch.runtime.parse import parse_launch

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card"),
]

ROOT = Path(__file__).resolve().parents[1]
DEV = torch.device("cuda:0")


def _cases():
    from nnstreamer_tpu_torch.ops import (decode_attention, depthwise_fma,
                                          flash_attention, fma_gemm)

    g = torch.Generator(device=DEV).manual_seed(0)

    def r(*s):
        return torch.randn(*s, generator=g, device=DEV)
    pos = torch.full((1,), 40, dtype=torch.int32, device=DEV)
    return {
        "decode_attention": (
            lambda q, k, v, p: decode_attention.decode_attention(q, k, v, p),
            (r(2, 4, 1, 64), r(2, 4, 128, 64), r(2, 4, 128, 64), pos),
            decode_attention.decode_attention),
        "flash_attention": (
            lambda q, k, v: flash_attention.flash_attention(q, k, v, True),
            (r(2, 4, 128, 64), r(2, 4, 128, 64), r(2, 4, 128, 64)),
            flash_attention.flash_attention),
        "fma_gemm": (
            lambda a, b: fma_gemm.fma_gemm(a, b, chains=2),
            (r(256, 96), r(96, 64)), fma_gemm.fma_gemm),
        "depthwise_fma": (
            lambda x, w: depthwise_fma.depthwise_fma(
                x, w, (1, 1), (1, 1), ((1, 1), (1, 1)), (14, 14)),
            (r(2, 14, 14, 32), r(1, 3, 3, 32)), depthwise_fma.depthwise_fma),
    }


_CHILD = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[1] + "/tests")
from nnstreamer_tpu_torch import aot
from test_torch_aot_cuda import _cases
out = {}
for name, (fn, args, wrapper) in _cases().items():
    loaded = aot.load_artifact(open(f"{sys.argv[2]}/{name}.pt2", "rb").read())
    want = fn(*args)
    n0 = wrapper.launches
    got = loaded.call(*args)[0]
    torch.cuda.synchronize()
    out[name] = {"equal": bool(torch.equal(got, want)),
                 "launches": wrapper.launches - n0,
                 "node": any(str(n.target) == f"nns.{name}.default"
                             for n in loaded.program.graph.nodes)}
print(json.dumps(out))
"""


def test_ops_export_and_load_in_fresh_process(tmp_path):
    for name, (fn, args, _w) in _cases().items():
        blob, _meta, _ = aot.export_stage(fn, args, poly=False)
        (tmp_path / f"{name}.pt2").write_bytes(blob)
    r = subprocess.run([sys.executable, "-c", _CHILD, str(ROOT),
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res == {name: {"equal": True, "launches": 1, "node": True}
                   for name in _cases()}


LINE = ("tensor_src device=true num-buffers=4 dimensions=16:8 "
        "types=float32 pattern=random ! tensor_transform mode=arithmetic "
        "option=add:1 ! tensor_filter framework=torch "
        "model=builtin://matmul?n=16 ! tensor_sink name=out max-stored=8")


def _run(line):
    pipe = parse_launch(line)
    pipe.run(timeout=120)
    out = pipe.get("out")
    vals = []
    while True:
        b = out.pull(timeout=0.2)
        if b is None:
            break
        assert b.tensors[0].is_cuda
        vals.append(b.tensors[0].cpu().numpy().tobytes())
    (seg,) = pipe.fused_segments
    return vals, seg.stats


def test_fused_segment_exports_then_hits_on_card(tmp_path, monkeypatch):
    monkeypatch.delenv(aot.CACHE_ENV, raising=False)
    live, _ = _run(LINE)
    monkeypatch.setenv(aot.CACHE_ENV, str(tmp_path / "c"))
    aot.reset_stats()
    first, s1 = _run(LINE)
    second, s2 = _run(LINE)
    assert (s1["aot_exports"], s1["aot_hits"]) == (1, 0)
    assert (s2["aot_exports"], s2["aot_hits"]) == (0, 1)
    assert s1["retraces"] == s2["retraces"] == 1   # one CUDA graph
    assert live == first == second and len(live) == 4
    (entry,) = aot.default_cache().list()
    assert entry["device"].startswith("cuda:") and entry["poly"]


def test_pt2_exported_on_card_refuses_the_cpu(tmp_path):
    from nnstreamer_tpu_torch.backends.base import (Accelerator,
                                                    FilterProperties)
    from nnstreamer_tpu_torch.backends.pt2_backend import (
        TorchExportBackend, export_callable)

    path = str(tmp_path / "s.pt2")
    export_callable(lambda x: x * 2.0, [torch.ones(4, 8, device=DEV)], path,
                    poly=True)
    b = TorchExportBackend()
    b.open(FilterProperties(model=path))
    out = b.invoke([np.ones((3, 8), np.float32)])[0]
    assert out.is_cuda and torch.equal(out.cpu(), torch.full((3, 8), 2.0))
    b.close()
    with pytest.raises(ValueError, match="exported on cuda"):
        TorchExportBackend().open(FilterProperties(
            model=path, accelerator=Accelerator.CPU))
