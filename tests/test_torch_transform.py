"""The port's tensor_transform (ops/transform_ops.py, elements/transform.py)
against nnstreamer_tpu's on the same numpy inputs, made from a seed.

The oracle is always ``jax.jit`` of nnstreamer_tpu's
``parse_transform_options(mode, option)`` (or its element), never a bare
call on numpy: the element jits its mode, and with 64-bit types off that
decides the dtypes (a typecast to float64 gives float32). Integer outputs
and every dtype must match exactly; float outputs within rtol 1e-6 (the
same float32 ops, which XLA may fuse or reorder); the arithmetic chains
of the hypothesis test also within 1e-6 of the largest intermediate
(XLA contracts a multiply and an add into one FMA). The stand mode reduces,
and a float32 mean summed in another order differs by ulps of the inputs,
so its outputs also get an absolute 1e-6 of the inputs' scale: 1e-6 for
"default" (unit-variance outputs), 1e-6 x max|x| for "dc-average"."""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nnstreamer_tpu.ops.transform_ops import (
    parse_transform_options as jax_parse_options,
)
from nnstreamer_tpu.runtime.parse import parse_launch as jax_parse_launch
from nnstreamer_tpu_torch.core import MessageType
from nnstreamer_tpu_torch.ops import transform_ops as tops
from nnstreamer_tpu_torch.runtime.parse import parse_launch

RTOL = 1e-6


def _inputs():
    rng = np.random.default_rng(20261017)
    return {
        "uint8": rng.integers(0, 256, (3, 4, 5)).astype(np.uint8),
        "int32": rng.integers(-1000, 1000, (3, 4, 5)).astype(np.int32),
        "float32": (rng.standard_normal((3, 4, 5)) * 10).astype(np.float32),
    }


INPUTS = _inputs()

CASES = [
    ("typecast", t) for t in ("uint8", "int8", "int16", "uint16", "int32",
                              "uint32", "float16", "float32", "float64",
                              "int64", "uint64")
] + [
    ("arithmetic", o) for o in (
        "typecast:float32,add:-127.5,div:127.5",
        "add:1",
        "typecast:float64,add:1",
        "typecast:int32,mul:0.5",
        "typecast:int32,div:2",
        "typecast:uint8,add:250",
        "typecast:int32,add:3,mul:2,sub:1",
        "typecast:int32,pow:2",
        "mul:0.5,pow:2",
        "typecast:uint32,sub:5",
        "typecast:uint16,mul:7000",
        "typecast:int8,add:200",
        "typecast:int64,mul:3",
        "per-channel:true@0,add:5@1,mul:2@2",
        "typecast:int32,per-channel:true@0,add:0.5@1",
        "typecast:uint8,per-channel:true@1,add:100@3",
        "per-channel:true@0,add:5@7",
        "per-channel:true@0,add:5@-1",
        "per-channel:false,add:2",
        "add:9.900000e-001:-80.256",
        "typecast:int32,pow:-1",
        "typecast:float32,sub:0.5,div:0",
    )
] + [
    ("transpose", "1:0:2"), ("transpose", "2:0:1"), ("transpose", "0:1"),
    ("dimchg", "0:2"), ("dimchg", "2:0"), ("dimchg", "-1:0"),
    ("stand", "default"), ("stand", "dc-average"),
    ("stand", "default:per-channel"), ("stand", "dc-average:per-channel"),
    ("clamp", "2.5:7"), ("clamp", "2:7"), ("clamp", "-1:300"),
    ("clamp", "7:2"), ("clamp", "-3.5:100"),
    ("padding", "1:1,2:0,0:1"), ("padding", "1:2,value:0.7"),
    ("padding", "1:1,0:0,1:0,value:-1"), ("padding", "1:0"),
]


def _jax(mode: str, option: str, x: np.ndarray):
    return np.asarray(jax.jit(jax_parse_options(mode, option))(x))


def _port(mode: str, option: str, x: np.ndarray) -> torch.Tensor:
    return tops.parse_transform_options(mode, option)(
        tops.canonicalize(torch.from_numpy(x.copy())))


def _stand_atol(option: str, x: np.ndarray) -> float:
    scale = 1.0 if option.startswith("default") else float(np.abs(x).max())
    return 1e-6 * max(scale, 1.0)


def _check(got: torch.Tensor, want: np.ndarray, what: str,
           atol: float = 0.0) -> None:
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name, what
    assert tuple(got.shape) == want.shape, what
    if got.is_floating_point():
        np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                                   rtol=RTOL, atol=atol, err_msg=what)
    else:
        # through int64: numpy has no view of torch's uint16/uint32
        np.testing.assert_array_equal(got.to(torch.int64).numpy(),
                                      want.astype(np.int64), err_msg=what)


@pytest.mark.parametrize("dtype", sorted(INPUTS))
@pytest.mark.parametrize("mode,option", CASES,
                         ids=[f"{m}-{o}" for m, o in CASES])
def test_mode_matches_jitted_jax(mode, option, dtype):
    x = INPUTS[dtype]
    try:
        want = _jax(mode, option, x)
    except Exception as e:  # noqa: BLE001 - the port must refuse it too
        with pytest.raises((TypeError, ValueError, RuntimeError)):
            _port(mode, option, x)
        assert isinstance(e, (TypeError, ValueError)), e
        return
    got = _port(mode, option, x)
    atol = _stand_atol(option, x) if mode == "stand" else 0.0
    _check(got, want, f"{mode} {option} on {dtype}", atol)
    # never written into its input
    np.testing.assert_array_equal(x, INPUTS[dtype])


# the JAX element's dtypes (jax.jit, 64-bit types off), row by row
JIT_DTYPES = [
    ("typecast", "float64", "uint8", "float32"),
    ("typecast", "int64", "int32", "int32"),
    ("arithmetic", "typecast:float64,add:1", "uint8", "float32"),
    ("arithmetic", "typecast:int32,mul:0.5", "int32", "float32"),
    ("arithmetic", "typecast:int32,div:2", "int32", "float32"),
    ("arithmetic", "add:1", "uint8", "float32"),
    ("arithmetic", "add:1", "int32", "float32"),
    ("clamp", "2.5:7", "int32", "float32"),
    ("clamp", "2.5:7", "uint8", "float32"),
    ("clamp", "2:7", "uint8", "uint8"),
    ("clamp", "2:7", "int32", "int32"),
]


@pytest.mark.parametrize("mode,option,in_dtype,out_dtype", JIT_DTYPES,
                         ids=[f"{m}-{o}-{i}" for m, o, i, _ in JIT_DTYPES])
def test_jitted_dtype_table(mode, option, in_dtype, out_dtype):
    x = INPUTS[in_dtype]
    assert _jax(mode, option, x).dtype.name == out_dtype
    assert _port(mode, option, x).dtype is getattr(torch, out_dtype)
    meta = torch.empty(x.shape, dtype=getattr(torch, in_dtype), device="meta")
    assert tops.parse_transform_options(mode, option)(meta).dtype \
        is getattr(torch, out_dtype)


def test_uint8_add_wraps_like_jax():
    x = np.full((2, 3), 11, np.uint8)
    want = _jax("arithmetic", "typecast:uint8,add:250", x)
    got = _port("arithmetic", "typecast:uint8,add:250", x)
    assert want.dtype == np.uint8 and (want == 5).all()
    assert got.dtype is torch.uint8 and (got == 5).all()


@pytest.mark.parametrize("option", ["default:per-channel",
                                    "dc-average:per-channel", "default"])
def test_stand_on_a_rank_1_tensor(option):
    x = INPUTS["float32"][0, 0]
    _check(_port("stand", option, x), _jax("stand", option, x), option,
           _stand_atol(option, x))


def test_stand_is_population_std():
    x = np.array([1, 2, 3, 4], np.float32)
    want = np.array([-1.3416408, -0.4472136, 0.4472136, 1.3416408], np.float32)
    np.testing.assert_allclose(_jax("stand", "default", x), want, rtol=RTOL)
    np.testing.assert_allclose(_port("stand", "default", x).numpy(), want,
                               rtol=RTOL)


@pytest.mark.parametrize("mode,option", [
    ("transpose", "5:0:1:2"), ("transpose", "0:0:1"), ("transpose", "0"),
    ("transpose", "a:b"), ("nosuchmode", ""), ("typecast", "uint9"),
    ("clamp", "x:1"), ("dimchg", "a:1"),
])
def test_option_errors_match(mode, option):
    with pytest.raises((ValueError, TypeError)) as want:
        jax_parse_options(mode, option)
    with pytest.raises((ValueError, TypeError)) as got:
        tops.parse_transform_options(mode, option)
    assert type(got.value) is type(want.value)


def test_unknown_arithmetic_op_raises_at_call():
    x = INPUTS["float32"]
    with pytest.raises(ValueError, match="unknown arithmetic op"):
        jax.jit(jax_parse_options("arithmetic", "foo:1"))(x)
    fn = tops.parse_transform_options("arithmetic", "foo:1")
    with pytest.raises(ValueError, match="unknown arithmetic op"):
        fn(torch.from_numpy(x))


_ARITH_OP = st.tuples(st.sampled_from(["add", "sub", "mul", "div"]),
                      st.sampled_from(["1", "2", "-3", "7", "0.5", "-1.25",
                                       "3.75", "127.5"]))


def _chain_scale(x: np.ndarray, ops) -> float:
    """The largest magnitude along a chain (float64, ignoring wraps): XLA
    contracts a multiply and an add into one FMA, which rounds once where
    the port rounds twice, so a float chain's error is relative to its
    intermediates, not to a result that cancelled."""
    v = x.astype(np.float64)
    scale = float(np.abs(v).max())
    for op, val in ops:
        val = float(val)
        v = {"add": v + val, "sub": v - val, "mul": v * val,
             "div": v / val}[op]
        scale = max(scale, float(np.abs(v).max()))
    return scale


@settings(max_examples=60, deadline=None, derandomize=True)
@given(in_dtype=st.sampled_from(sorted(INPUTS)),
       cast=st.sampled_from([None, "float32", "int32", "uint8", "int16",
                             "float64", "int64"]),
       ops=st.lists(_ARITH_OP, min_size=1, max_size=4))
def test_arithmetic_chains_match_jax(in_dtype, cast, ops):
    option = ",".join(([f"typecast:{cast}"] if cast else [])
                      + [f"{op}:{v}" for op, v in ops])
    x = INPUTS[in_dtype]
    _check(_port("arithmetic", option, x), _jax("arithmetic", option, x),
           f"{option} on {in_dtype}", RTOL * _chain_scale(x, ops))


# -- the element: caps, device rule, apply --------------------------------

def _run_line(parse, line: str, arrays):
    pipe = parse(line)
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    try:
        for a in arrays:
            pipe.get("in").push_buffer(list(a))
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=60)
        caps = pipe.get("out").sinkpad.caps
    finally:
        pipe.stop()
    return msg, caps, got


def _caps_str(arrays) -> str:
    dims = ".".join(":".join(str(d) for d in reversed(a.shape))
                    for a in arrays)
    types = ".".join(a.dtype.name for a in arrays)
    return (f"other/tensors,format=static,num_tensors={len(arrays)},"
            f"dimensions={dims},types={types}")


ELEMENT_CASES = [
    (mode, option, dtype) for mode, option, dtype, _ in JIT_DTYPES
] + [
    ("arithmetic", "typecast:uint8,add:250", "uint8"),
    ("arithmetic", "typecast:float32,add:-127.5,div:127.5", "uint8"),
    ("arithmetic", "per-channel:true@0,add:5@1,mul:2@2", "float32"),
    ("transpose", "2:0:1", "int32"),
    ("dimchg", "0:2", "uint8"),
    ("stand", "default:per-channel", "int32"),
    ("padding", "1:1,0:2,1:0,value:3", "uint8"),
    ("typecast", "float16", "float32"),
    ("transpose", "1:0:2", "float64"),
]


@pytest.mark.parametrize("mode,option,dtype", ELEMENT_CASES,
                         ids=[f"{m}-{o}-{d}" for m, o, d in ELEMENT_CASES])
def test_element_caps_and_output_match_jax(mode, option, dtype):
    x = (INPUTS[dtype] if dtype in INPUTS
         else INPUTS["float32"].astype(dtype))
    head = f"appsrc name=in caps={_caps_str([x])} ! tensor_transform " \
           f"mode={mode} option={option}"
    tail = " ! tensor_sink name=out"
    wmsg, wcaps, want = _run_line(jax_parse_launch, head + tail, [[x]])
    gmsg, gcaps, got = _run_line(parse_launch, head + " accelerator=cpu" + tail,
                                 [[x]])
    assert wmsg.type.value == gmsg.type.value == "eos", (wmsg, gmsg)
    assert str(gcaps) == str(wcaps)
    assert len(got) == len(want) == 1
    t = got[0].tensors[0]
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    atol = _stand_atol(option, x) if mode == "stand" else 0.0
    _check(t, np.asarray(want[0].tensors[0]), f"{mode} {option}", atol)


def test_apply_transforms_only_the_named_tensors():
    a, b = INPUTS["uint8"], INPUTS["int32"]
    head = (f"appsrc name=in caps={_caps_str([a, b])} ! tensor_transform "
            "mode=arithmetic option=typecast:float32,mul:2 apply=1")
    tail = " ! tensor_sink name=out"
    _, wcaps, want = _run_line(jax_parse_launch, head + tail, [[a, b]])
    _, gcaps, got = _run_line(parse_launch, head + " accelerator=cpu" + tail,
                              [[a, b]])
    assert str(gcaps) == str(wcaps)
    for g, w in zip(got[0].tensors, want[0].tensors):
        _check(g, np.asarray(w), "apply=1")


def test_apply_out_of_range_posts_an_error():
    a = INPUTS["uint8"]
    line = (f"appsrc name=in caps={_caps_str([a])} ! tensor_transform "
            "mode=typecast option=float32 apply=3 {acc}! tensor_sink name=out")
    wmsg, _, _ = _run_line(jax_parse_launch, line.format(acc=""), [[a]])
    gmsg, _, _ = _run_line(parse_launch, line.format(acc="accelerator=cpu "),
                           [[a]])
    assert wmsg.type.value == gmsg.type.value == "error"
    assert "out of range" in str(gmsg.data)


def test_reference_extra_colon_line():
    """tests/test_reference_launch_compat.py::
    test_arithmetic_extra_colon_value_uses_first, through the port (the CPU
    asked for)."""
    pipe = parse_launch(
        "tensor_src num-buffers=1 dimensions=4 types=float32 pattern=counter "
        "! tensor_transform mode=arithmetic option=add:9.900000e-001:-80.256 "
        "accelerator=cpu ! tensor_sink name=out")
    got = []
    pipe.get("out").connect(got.append)
    pipe.play(); pipe.wait(timeout=30); pipe.stop()
    np.testing.assert_allclose(np.asarray(got[0].tensors[0]), 0.99, rtol=1e-6)


def test_without_a_card_the_transform_posts_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    a = INPUTS["uint8"]
    msg, _, got = _run_line(
        parse_launch, f"appsrc name=in caps={_caps_str([a])} ! "
        "tensor_transform mode=typecast option=float32 ! tensor_sink "
        "name=out", [[a]])
    assert msg.type is MessageType.ERROR and not got
    assert "no CUDA device" in str(msg.data)
    assert "cpu" in str(msg.data)


def test_transform_never_writes_its_input():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    before = x.clone()
    for option in ("per-channel:true@0,add:5@1", "add:1,mul:2"):
        tops.parse_transform_options("arithmetic", option)(x)
    assert torch.equal(x, before)


def test_transpose_rank_limit_is_read_only_constant():
    from nnstreamer_tpu_torch.registry.elements import make_element

    t = make_element("tensor_transform", mode="typecast", option="float32")
    assert t.get_property("transpose-rank-limit") == 4
