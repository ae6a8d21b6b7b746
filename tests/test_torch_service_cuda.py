"""The service plane on the card (marker ``cuda``; skips without a card).
This file needs neither JAX nor nnstreamer_tpu:

    python -m pytest --noconftest -q -m cuda tests/test_torch_service_cuda.py

Phase 18 of chip_smoke.py in small form:

* a hot swap of a model slot releases the old backend only after a fence
  behind the last work that read its weights, and frees them, unfused
  and in a fused segment, swap after swap;
* supervised restarts of a card pipeline leak no card memory;
* a process replica opens its model on cuda:0 and answers through the
  pool."""
import time

import numpy as np
import pytest
import torch

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA card"),
]

V1 = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_u8"
V2 = "nnstreamer_tpu_torch.models.mobilenet_v2:filter_model_u8_seed1"
CAPS = "other/tensors,format=static,dimensions=3:224:224:2,types=uint8"


def _wait(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not met in time"
        time.sleep(0.01)


def _frame(seed=0):
    return np.random.default_rng(seed).integers(
        0, 255, (2, 224, 224, 3)).astype(np.uint8)


# a lone filter (unfused) and a typecast → filter segment (fused: the swap
# drops its graphs and the next frame captures again)
@pytest.mark.parametrize("mid", ["", "tensor_transform mode=typecast "
                                 "option=uint8 ! "], ids=["unfused", "fused"])
def test_swap_releases_the_old_weights_after_a_fence(mid):
    from nnstreamer_tpu_torch.obs.memory import backend_param_nbytes
    from nnstreamer_tpu_torch.service import ServiceManager

    mgr = ServiceManager(jitter_seed=0)
    try:
        mgr.models.define("m", {"1": V1, "2": V2}, active="1")
        svc = mgr.register(
            "s", f"appsrc name=in caps={CAPS} ! {mid}tensor_filter "
            "framework=torch model=registry://m name=f ! tensor_sink "
            "name=out max-stored=4", warmup="none").start()
        assert len(svc.pipeline.fused_segments) == (1 if mid else 0)
        outs = []
        svc.pipeline.get("out").connect(lambda b: outs.append(b))
        svc.pipeline.get("in").push_buffer(_frame())
        _wait(lambda: len(outs) == 1)
        f = svc.pipeline.get("f")
        # the swap's warmup runs on this thread: give it its cuBLAS
        # handle and workspace first (kept per thread, not per model)
        f.backend.invoke([_frame()])
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        param_bytes = backend_param_nbytes(f.backend)
        assert param_bytes > (4 << 20)   # MobileNet-v2 in bf16: ~7 MiB
        # v1 → v2, then back and forth: the bytes must not climb
        for k, ver in enumerate(("2", "1", "2")):
            assert mgr.models.swap("m", ver)["flipped"] == 1
            kinds = [kind for kind, _ in list(f.swap_log)[-2:]]
            assert kinds[0] in ("segment fence", "stream fence")
            assert kinds[1] == "released"
            svc.pipeline.get("in").push_buffer(_frame())
            _wait(lambda: len(outs) == k + 2)
            assert outs[-1].tensors[0].is_cuda
            torch.cuda.synchronize()
            # the same architecture, read after an answer as before the
            # swap: the old weights went as the new came (a kept model
            # would add param_bytes)
            after = torch.cuda.memory_allocated()
            assert abs(after - before) < param_bytes // 2, (ver, before,
                                                            after,
                                                            param_bytes)
    finally:
        mgr.shutdown()


def test_supervised_restarts_leak_no_card_memory():
    from nnstreamer_tpu_torch.service import RestartPolicy, ServiceManager

    mgr = ServiceManager(jitter_seed=0)
    try:
        svc = mgr.register(
            "crashy", f"appsrc name=in caps={CAPS} ! tensor_fault "
            "crash-at-buffer=1 crash-repeat=true name=fault ! "
            f"tensor_filter framework=torch model={V1} ! tensor_sink "
            "name=out", warmup="none",
            restart=RestartPolicy(mode="always", backoff_base_s=0.05,
                                  jitter=0.0, max_restarts=10)).start()
        outs, served = [], []
        svc.pipeline.get("out").connect(lambda b: outs.append(1))
        for cycle in range(4):
            n = len(outs)
            svc.pipeline.get("in").push_buffer(_frame())   # answered
            _wait(lambda: len(outs) > n)
            torch.cuda.synchronize()
            served.append(torch.cuda.memory_allocated())
            if cycle == 3:
                break
            svc.pipeline.get("in").push_buffer(_frame(1))  # crashes
            _wait(lambda: svc.supervisor.restarts == cycle + 1
                  and svc.generation == cycle + 2)
        assert svc.supervisor.crash_reports[-1].source == "fault"
        # the model's card bytes after each restart's first answer
        assert abs(served[-1] - served[0]) < (64 << 20), served
    finally:
        mgr.shutdown()


def test_process_replica_opens_its_model_on_cuda0():
    from nnstreamer_tpu_torch.service import ProcReplicaSet

    ps = ProcReplicaSet("card-r", f"tensor_filter framework=torch "
                        f"model={V1}", CAPS, replicas=1,
                        spawn_timeout_s=120.0)
    try:
        ps.start()
        with ps._lock:
            info = ps._slots[ps._order[0]].proc.info
        assert info["devices"] == ["cuda:0"]
        out = ps.request([_frame()], key="k", timeout=60.0)
        assert tuple(out.tensors[0].shape) == (2, 1001)
    finally:
        ps.stop()
