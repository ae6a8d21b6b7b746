"""The port's streaming and multi-turn generation (``make_streaming``,
``make_session``, ``prefill_continue`` and the ``tensor_generate`` element)
against nnstreamer_tpu's, at the ``tiny`` config on the CPU, on the same
weights (nnstreamer_tpu's tiny parameters carried over by
models/convert.py). Greedy and session tokens agree exactly; the chunked
prefill's logits and cache within rtol 1e-4 / atol 1e-5 (the same f32 math
in another summation order, as in test_torch_model.py)."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax

from nnstreamer_tpu.models import decoding as jdec
from nnstreamer_tpu.models import lm_serving as jlm
from nnstreamer_tpu.models import transformer as jtr
from nnstreamer_tpu_torch.core import Buffer, MessageType
from nnstreamer_tpu_torch.models import decoding as tdec
from nnstreamer_tpu_torch.models import lm_serving as tlm
from nnstreamer_tpu_torch.runtime.parse import parse_launch

B, P, S = 4, 6, 6
RTOL, ATOL = 1e-4, 1e-5
CPU = torch.device("cpu")
ENTRY = "nnstreamer_tpu_torch.models.lm_serving:tiny_from_jax"


@pytest.fixture(scope="module")
def tree():
    """nnstreamer_tpu's tiny parameters (its entry's seed) as numpy."""
    return jax.tree_util.tree_map(
        np.asarray, jtr.init_params(jlm.tiny.cfg, seed=jlm.tiny.seed))


@pytest.fixture(scope="module")
def entry(tree):
    """The port's tiny entry on those weights, also reachable from a
    launch line as ``ENTRY``."""
    e = replace(tlm.tiny, params=tree)
    tlm.tiny_from_jax = e
    yield e
    del tlm.tiny_from_jax


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(23).integers(0, 64, (B, P)).astype(np.int32)


def _p2(seed=31, n=3):
    return np.random.default_rng(seed).integers(0, 64, (B, n)).astype(np.int32)


def _cat(tokens):
    return np.stack([np.asarray(t) for t in tokens], axis=1)


def _launch(extra=""):
    return parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions={P}:{B},types=int32 "
        f"! tensor_generate model={ENTRY} steps={S} accelerator=cpu "
        f"{extra} name=g ! tensor_sink name=out max-stored=64")


def _generate_stream(*buffers, extra=""):
    pipe = _launch(extra)
    got = []
    pipe.get("out").connect(got.append)
    pipe.play()
    try:
        for buf in buffers:
            pipe.get("in").push_buffer(buf)
        pipe.get("in").end_of_stream()
        msg = pipe.wait(timeout=120)
    finally:
        pipe.stop()
    assert msg.type is MessageType.EOS, msg
    return got


def _post_error(extra, model=ENTRY, steps=S):
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions={P}:{B},types=int32 "
        f"! tensor_generate model={model} steps={steps} accelerator=cpu "
        f"{extra} ! tensor_sink name=out")
    pipe.play()
    try:
        pipe.get("in").push_buffer(np.zeros((B, P), np.int32))
        msg = pipe.bus.wait_for((MessageType.ERROR,), timeout=60)
    finally:
        pipe.stop()
    assert msg is not None
    return str(msg.data.get("error", ""))


def test_stream_matches_jax_stream(entry, prompt):
    want = _cat(jlm.tiny.make_streaming()(prompt, S))
    got = list(entry.make_streaming("cpu")(prompt, S))
    assert all(t.dtype is torch.int32 and tuple(t.shape) == (B,) for t in got)
    np.testing.assert_array_equal(_cat(got), want)


def test_element_matches_filter_suffix(entry, prompt, monkeypatch):
    bufs = _generate_stream(prompt)
    assert len(bufs) == S
    toks = [np.asarray(b.tensors[0]) for b in bufs]
    assert all(isinstance(t, np.ndarray) and t.shape == (B, 1)
               and t.dtype == np.int32 for t in toks)
    # per-buffer framing metadata
    assert [b.meta["gen_step"] for b in bufs] == list(range(S))
    assert [b.meta["gen_last"] for b in bufs] == [False] * (S - 1) + [True]

    monkeypatch.setenv("NNS_LM_STEPS", str(S))
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions={P}:{B},types=int32 "
        f"! tensor_filter framework=torch accelerator=cpu model={ENTRY} "
        "! tensor_sink name=out max-stored=4")
    whole = []
    pipe.get("out").connect(lambda b: whole.append(
        np.asarray(b.as_numpy().tensors[0])))
    pipe.play()
    pipe.get("in").push_buffer(prompt)
    pipe.get("in").end_of_stream()
    pipe.wait(timeout=120)
    pipe.stop()
    assert whole[0].shape == (B, P + S)
    np.testing.assert_array_equal(np.concatenate(toks, axis=1),
                                  whole[0][:, P:])
    # and the JAX package's stream on the same weights
    np.testing.assert_array_equal(np.concatenate(toks, axis=1),
                                  _cat(jlm.tiny.make_streaming()(prompt, S)))


def test_session_matches_jax_session_and_concat_oracle(entry, tree, prompt):
    """Multi-turn: turn 2 on the persisted cache equals the JAX session
    token for token and equals generating from the whole history
    (P1 + G1 + P2) from scratch; reset() repeats turn 1."""
    session = entry.make_session("cpu")
    g1 = _cat(session.generate(prompt, S))
    assert session.position == P + S - 1
    g2 = _cat(session.generate(_p2(), S))

    jsession = jlm.tiny.make_session()
    np.testing.assert_array_equal(g1, _cat(jsession.generate(prompt, S)))
    np.testing.assert_array_equal(g2, _cat(jsession.generate(_p2(), S)))
    assert session.position == jsession.position

    full = np.concatenate([prompt, g1, _p2()], axis=1)
    whole = tdec.make_generate(entry.cfg)(
        entry.build_params(CPU), torch.from_numpy(full), S).numpy()
    np.testing.assert_array_equal(whole[:, :full.shape[1]], full)
    np.testing.assert_array_equal(g2, whole[:, full.shape[1]:])

    session.reset()
    assert session.position == 0
    np.testing.assert_array_equal(_cat(session.generate(prompt, S)), g1)


def test_conversation_element_multi_turn(entry, prompt):
    """conversation=true keeps the cache across prompt buffers; a buffer
    with meta reset=True starts over."""
    reset = Buffer([prompt], meta={"reset": True})
    got = _generate_stream(prompt, _p2(), reset, extra="conversation=true")
    assert len(got) == 3 * S
    turns = [np.concatenate([np.asarray(b.tensors[0]) for b in got[i:i + S]],
                            axis=1) for i in range(0, 3 * S, S)]
    session = entry.make_session("cpu")
    np.testing.assert_array_equal(turns[0], _cat(session.generate(prompt, S)))
    np.testing.assert_array_equal(turns[1], _cat(session.generate(_p2(), S)))
    np.testing.assert_array_equal(turns[2], turns[0])
    assert got[2 * S].meta["reset"] is True


@pytest.mark.parametrize("n", [1, 5])
def test_prefill_continue_matches_jax(entry, tree, prompt, n):
    """Chunked ingestion of n tokens at P..P+n-1 against the cache prefix:
    logits and cache agree with JAX's, and the cache equals a from-scratch
    prefill over history + chunk."""
    jcfg, tcfg = jlm.tiny.cfg, entry.cfg
    params = entry.build_params(CPU)
    chunk = _p2(n=n)
    jl, jc, jpos = jdec.prefill(jcfg, tree, prompt, jdec.init_cache(jcfg, B))
    jl, jc, jpos = jdec.prefill_continue(jcfg, tree, chunk, jc, jpos)
    cache = tdec.init_cache(tcfg, B, device=CPU)
    _, cache, pos = tdec.prefill(tcfg, params, torch.from_numpy(prompt), cache)
    tl, cache, tpos = tdec.prefill_continue(tcfg, params,
                                            torch.from_numpy(chunk), cache, pos)
    assert int(jpos) == tpos == P + n
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
    fl, fresh, _ = tdec.prefill(
        tcfg, params, torch.from_numpy(np.concatenate([prompt, chunk], 1)),
        tdec.init_cache(tcfg, B, device=CPU))
    torch.testing.assert_close(tl, fl, rtol=RTOL, atol=ATOL)
    for jlayer, tlayer, flayer in zip(jc, cache, fresh):
        for key in ("k", "v"):
            np.testing.assert_allclose(tlayer[key].numpy(),
                                       np.asarray(jlayer[key]),
                                       rtol=RTOL, atol=ATOL)
            torch.testing.assert_close(tlayer[key], flayer[key],
                                       rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="does not fit"):
        tdec.prefill_continue(tcfg, params, torch.from_numpy(chunk), cache,
                              tcfg.max_seq - n + 1)


def test_abandoned_turn_leaves_session_usable(entry, prompt):
    session = entry.make_session("cpu")
    it = session.generate(prompt, S)
    next(it)  # take one token, abandon the turn (e.g. early EOS)
    del it
    pos_after_abandon = session.position
    assert pos_after_abandon == P
    toks = list(session.generate(_p2(41, 2), 3))
    assert len(toks) == 3
    assert session.position == pos_after_abandon + 3 + 2
    # the same as JAX's session after the same abandoned turn
    jsession = jlm.tiny.make_session()
    jit = jsession.generate(prompt, S)
    next(jit)
    del jit
    np.testing.assert_array_equal(_cat(toks),
                                  _cat(jsession.generate(_p2(41, 2), 3)))


def test_temperature_sampling_deterministic_per_seed(entry, prompt):
    """Same seed, same tokens (numpy integer seeds included); another seed,
    other tokens; continuation turns reproducible across sessions."""
    stream = entry.make_streaming("cpu", temperature=1.0)
    a = _cat(stream(prompt, S, rng=7))
    b = _cat(stream(prompt, S, rng=np.int64(7)))
    c = _cat(stream(prompt, S, rng=8))
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    assert a.min() >= 0 and a.max() < 64
    with pytest.raises(TypeError, match="int seed"):
        next(stream(prompt, S, rng="seven"))

    sA = entry.make_session("cpu", temperature=1.0)
    sB = entry.make_session("cpu", temperature=1.0)
    for s in (sA, sB):
        list(s.generate(prompt, S, rng=7))
    tA = _cat(sA.generate(_p2(3, 2), S, rng=7))
    tB = _cat(sB.generate(_p2(3, 2), S, rng=7))
    np.testing.assert_array_equal(tA, tB)


def test_element_temperature_prop(entry, prompt):
    def run(seed):
        bufs = _generate_stream(prompt, extra=f"temperature=1.0 seed={seed}")
        return np.concatenate([np.asarray(b.tensors[0]) for b in bufs], axis=1)

    ta, tb, tc = run(5), run(5), run(6)
    np.testing.assert_array_equal(ta, tb)
    assert (ta != tc).any()


def test_serve_knobs_on_launch_line(entry, prompt):
    """serve-dtype/cache-len reach the entry from the launch string;
    cache-len alone is token-exact with the default stream."""
    base = _generate_stream(prompt)
    sized = _generate_stream(prompt, extra=f"cache-len={P + S + 2}")
    assert len(sized) == len(base) == S
    for a, b in zip(base, sized):
        np.testing.assert_array_equal(a.tensors[0], b.tensors[0])
    bf16 = _generate_stream(
        prompt, extra=f"cache-len={P + S + 2} serve-dtype=bfloat16")
    assert len(bf16) == S  # runs end to end; bf16 may flip rare argmax ties


def test_stream_rejects_bad_requests(entry, prompt):
    stream = entry.make_streaming("cpu")
    with pytest.raises(ValueError, match="steps=0"):
        next(stream(prompt, 0))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        next(stream(prompt, 64))
    with pytest.raises(ValueError, match=r"\(B, P\)"):
        next(stream(prompt[0], S))
    session = entry.make_session("cpu")
    list(session.generate(prompt, S))
    with pytest.raises(ValueError, match="conversation batch changed"):
        next(session.generate(prompt[:2], S))
    with pytest.raises(ValueError, match=r"conversation at pos 11 .*max_seq"):
        next(session.generate(prompt, 60))


@pytest.mark.parametrize("extra,model,steps,match", [
    ("", "nnstreamer_tpu_torch.models.transformer:forward", S,
     "make_streaming"),
    ("conversation=true", "nnstreamer_tpu_torch.models.transformer:forward",
     S, "make_session"),
    ("", ENTRY, 500, "max_seq"),
    ("serve-dtype=bfloat16", "nnstreamer_tpu_torch.models.transformer:forward",
     2, "dataclass"),
    ("cache-len=-1", ENTRY, S, "cache_len must be >= 0"),
    ("mesh=2x4", ENTRY, S, "mesh='2x4' is not ported"),
    ("", "tiny_without_module", S, "module:attr"),
], ids=["no-streaming", "no-session", "overlong", "knobs-need-dataclass",
        "negative-cache-len", "mesh", "bad-model"])
def test_bad_properties_post_errors(entry, extra, model, steps, match):
    assert match in _post_error(extra, model, steps)


def test_accelerator_grammar():
    """The element's accelerator words, through the helper tensor_filter
    shares; a bad word is a bus error naming the grammar."""
    from nnstreamer_tpu_torch.utils.hw_accel import device_for_accelerator

    assert device_for_accelerator("cpu") == CPU
    assert device_for_accelerator(" CPU ") == CPU
    for word in ("tpu", "cuda:x"):
        with pytest.raises(ValueError, match="accelerator"):
            device_for_accelerator(word)
    if not torch.cuda.is_available():
        for word in ("auto", "gpu", "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                device_for_accelerator(word)
    assert "cuda:N, cpu" in _post_error("accelerator=tpu")


def test_element_defaults_to_the_card(entry, prompt):
    """Without accelerator=cpu the element asks for the card; here, with
    none, that is a bus error naming the way to ask for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    assert "accelerator=cpu" in _post_error("accelerator=auto")
