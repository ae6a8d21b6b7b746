"""SingleShot (single.py) and the shared-model table: the port against
nnstreamer_tpu.

Both packages open the same builtin models — nnstreamer_tpu's on JAX-CPU,
the port's with ``accelerator="cpu"`` — and are held to the same
outputs, errors (type and text) and timeout behaviour: a bounded invoke
raises TimeoutError, a second invoke refuses while the late one runs, and
the late result is never handed to a later call."""
import threading
import time

import numpy as np
import pytest

from nnstreamer_tpu.core import TensorsInfo as JTensorsInfo
from nnstreamer_tpu.core.tensors import TensorSpec as JTensorSpec
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu.single import SingleShot as JSingleShot
from nnstreamer_tpu_torch.core import TensorsInfo
from nnstreamer_tpu_torch.core.tensors import TensorSpec
from nnstreamer_tpu_torch.runtime.parse import parse_launch
from nnstreamer_tpu_torch.single import SingleShot

SLEEPY = "builtin://sleeper?ms=400&factor=2"


def port_shot(model, **kw):
    return SingleShot("torch", model, accelerator="cpu", **kw)


def ref_shot(model, **kw):
    return JSingleShot("jax", model, **kw)


BOTH = [
    pytest.param((port_shot, TensorsInfo, TensorSpec), id="port"),
    pytest.param((ref_shot, JTensorsInfo, JTensorSpec), id="reference"),
]


def _declared(shot, info_cls, spec_cls, shape=(4,)):
    """Declare the model's input (SET_INPUT_INFO), which both backends
    then serve as the model info the invoke checks against."""
    shot.set_input_info(info_cls.of(spec_cls(shape, "float32")))
    return shot


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, np.ndarray) else np.asarray(x)


def test_invoke_matches_the_reference():
    x = np.random.default_rng(0).standard_normal((2, 2)).astype(np.float32)
    with port_shot("builtin://scaler?factor=2") as s, \
            ref_shot("builtin://scaler?factor=2") as r:
        got, want = s.invoke(x), r.invoke(x)
        info = s.set_input_info(TensorsInfo.of(TensorSpec((2, 2), "float32")))
        jinfo = r.set_input_info(JTensorsInfo.of(JTensorSpec((2, 2), "float32")))
        assert info.describe() == jinfo.describe()
        assert s.get_model_info()[0].describe() == \
            r.get_model_info()[0].describe()
    assert _np(got[0]).tobytes() == _np(want[0]).tobytes()
    assert s.stats.total_invokes == r.stats.total_invokes == 1
    assert s.backend is None


@pytest.mark.parametrize("make", BOTH)
class TestInvokeTimeout:
    def test_fast_invoke_within_timeout(self, make):
        shot, _, _ = make
        with shot("builtin://scaler?factor=2", timeout_ms=2000) as s:
            out = s.invoke(np.ones(4, np.float32))
            np.testing.assert_allclose(_np(out[0]), 2.0)
            assert s.stats.total_invokes == 1

    def test_wedged_invoke_raises_and_late_result_discarded(self, make):
        shot, _, _ = make
        with shot(SLEEPY, timeout_ms=120) as s:
            s.invoke(np.ones(4, np.float32), timeout_ms=0)  # build + warm
            with pytest.raises(TimeoutError, match="120 ms"):
                s.invoke(np.ones(4, np.float32))
            # while the stale invoke still runs, a new one must refuse
            with pytest.raises(RuntimeError, match="still running"):
                s.invoke(np.ones(4, np.float32))
            time.sleep(0.6)  # let the stale invoke land
            out = s.invoke(np.full(4, 3.0, np.float32), timeout_ms=5000)
            # MUST be the fresh answer (3*2), not the stale one (1*2)
            np.testing.assert_allclose(_np(out[0]), 6.0)

    def test_per_call_timeout_overrides_instance(self, make):
        shot, _, _ = make
        with shot(SLEEPY) as s:  # unbounded
            s.invoke(np.ones(4, np.float32))
            t0 = time.monotonic()
            with pytest.raises(TimeoutError):
                s.invoke(np.ones(4, np.float32), timeout_ms=50)
            assert time.monotonic() - t0 < 0.39
            time.sleep(0.5)

    def test_set_timeout_zero_restores_blocking(self, make):
        shot, _, _ = make
        with shot(SLEEPY, timeout_ms=50) as s:
            s.set_timeout(0)
            out = s.invoke(np.ones(4, np.float32))  # blocks, no raise
            np.testing.assert_allclose(_np(out[0]), 2.0)

    def test_close_drains_a_late_invoke(self, make):
        shot, _, _ = make
        s = shot(SLEEPY, timeout_ms=50)
        s.invoke(np.ones(4, np.float32), timeout_ms=0)
        with pytest.raises(TimeoutError):
            s.invoke(np.ones(4, np.float32))
        s.close(drain_timeout_s=5.0)
        assert s.backend is None and s._pending is None
        with pytest.raises(RuntimeError, match="closed"):
            s.invoke(np.ones(4, np.float32))


def _errors(make_args, *inputs, **kw):
    """(type, text) of the error both packages raise for ``inputs``."""
    out = []
    for shot, info_cls, spec_cls in (a.values[0] for a in BOTH):
        with shot("builtin://scaler?factor=2", **kw) as s:
            _declared(s, info_cls, spec_cls, *make_args)
            with pytest.raises((ValueError, TypeError)) as ei:
                s.invoke(*inputs)
            out.append((type(ei.value), str(ei.value)))
    assert out[0] == out[1]
    return out[0]


class TestInputValidation:
    def test_wrong_tensor_count(self):
        kind, text = _errors((), np.ones(4, np.float32), np.ones(4, np.float32))
        assert kind is ValueError and "1" in text

    def test_wrong_dtype(self):
        kind, text = _errors((), np.ones(4, np.float64))
        assert kind is TypeError and "float64" in text

    def test_wrong_shape(self):
        kind, text = _errors((), np.ones((2, 3), np.float32))
        assert kind is ValueError and "shape" in text

    def test_wrong_length_rank1_rejected(self):
        kind, text = _errors((), np.ones(3, np.float32))
        assert kind is ValueError and "shape" in text

    def test_non_batch_dims_checked(self):
        kind, text = _errors(((2, 4),), np.ones((2, 5), np.float32))
        assert kind is ValueError and "shape" in text

    @pytest.mark.parametrize("make", BOTH)
    def test_validate_false_skips(self, make):
        shot, info_cls, spec_cls = make
        with shot("builtin://scaler?factor=2", validate=False) as s:
            _declared(s, info_cls, spec_cls)
            out = s.invoke(np.ones(8, np.float32))  # model tolerates it
            assert _np(out[0]).shape == (8,)

    @pytest.mark.parametrize("make", BOTH)
    def test_batch_polymorphic_leading_dim_allowed(self, make):
        shot, info_cls, spec_cls = make
        with shot("builtin://add?value=1") as s:
            _declared(s, info_cls, spec_cls, (1, 4))
            out = s.invoke(np.zeros((16, 4), np.float32))
            assert _np(out[0]).shape == (16, 4)

    def test_torch_inputs_are_checked_without_a_copy(self):
        import torch

        with port_shot("builtin://scaler?factor=2") as s:
            _declared(s, TensorsInfo, TensorSpec)
            with pytest.raises(TypeError, match="int32"):
                s.invoke(torch.ones(4, dtype=torch.int32))
            out = s.invoke(torch.ones(4))
            assert float(out[0][0]) == 2.0


class TestSharedModel:
    LINE = ("tensor_src num-buffers=2 dimensions=2 types=float32 "
            "pattern=ones name=s ! tee name=t "
            "t. ! queue ! tensor_filter framework={fw} "
            "model=builtin://scaler?factor=2 shared-tensor-filter-key=k1 "
            "{acc}name=f1 ! tensor_sink name=o1 "
            "t. ! queue ! tensor_filter framework={fw} "
            "model=builtin://scaler?factor=2 shared-tensor-filter-key=k1 "
            "{acc}name=f2 ! tensor_sink name=o2")

    @pytest.mark.parametrize("fw,acc,parse", [
        ("torch", "accelerator=cpu ", parse_launch),
        ("jax", "", jax_parse_launch)], ids=["port", "reference"])
    def test_shared_backend_instance(self, fw, acc, parse):
        pipe = parse(self.LINE.format(fw=fw, acc=acc))
        pipe.play()
        pipe.wait(timeout=15)
        f1, f2 = pipe.get("f1"), pipe.get("f2")
        assert f1.backend is f2.backend  # one opened model, two elements
        pipe.stop()

    @pytest.mark.parametrize("fw,acc,parse,shot", [
        ("torch", "accelerator=cpu ", parse_launch, port_shot),
        ("jax", "", jax_parse_launch, ref_shot)], ids=["port", "reference"])
    def test_singleshot_and_filter_share_one_backend(self, fw, acc, parse,
                                                     shot):
        """The bench flow: SingleShot opens under a share key, the
        pipeline filter joins it — one instance, opened once, and the
        invoke gives the line's bytes."""
        from nnstreamer_tpu.backends import base as jbase
        from nnstreamer_tpu_torch.backends import base as tbase

        base = tbase if fw == "torch" else jbase
        x = np.random.default_rng(1).standard_normal((2, 4)).astype(np.float32)
        with shot("builtin://scaler?factor=2", share_key="bench") as s:
            s.invoke(x)
            pipe = parse(
                "appsrc name=in caps=other/tensors,format=static,"
                f"dimensions=4:2,types=float32 ! tensor_filter framework={fw} "
                f"model=builtin://scaler?factor=2 {acc}"
                "shared-tensor-filter-key=bench name=f ! tensor_sink name=out")
            pipe.play()
            pipe.get("in").push_buffer(x)
            line_out = pipe.get("out").pull(timeout=10)
            assert pipe.get("f").backend is s.backend
            assert base._shared["bench"].refcount == 2
            # the filter negotiated (2, 4): the shared backend now checks it
            with pytest.raises(ValueError, match="shape"):
                s.invoke(np.ones((2, 5), np.float32))
            direct = s.invoke(x)
            pipe.get("in").end_of_stream()
            pipe.wait(timeout=10)
            pipe.stop()
            assert base._shared["bench"].refcount == 1
        assert "bench" not in base._shared
        assert _np(direct[0]).tobytes() == _np(line_out.tensors[0]).tobytes()


def test_worker_runs_without_a_card_stream_on_the_cpu():
    with port_shot(SLEEPY, timeout_ms=5000) as s:
        assert s._caller_stream() is None
        assert str(s.device) == "cpu"
        results = []

        def call():
            results.append(s.invoke(np.ones(4, np.float32)))
        th = threading.Thread(target=call)
        th.start()
        th.join(10)
        np.testing.assert_allclose(_np(results[0][0]), 2.0)


def test_no_card_means_no_quiet_fallback():
    """Without accelerator=cpu a SingleShot opens on cuda:0; without a
    card that fails rather than running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(Exception, match="(?i)cuda|device"):
        SingleShot("torch", "builtin://scaler?factor=2")
