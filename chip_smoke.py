#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nnstreamer_tpu_torch) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the
package beside this file; it imports nothing of JAX or nnstreamer_tpu. It
exits non-zero, printing no result, when any of these is missing or any
phase fails:

1. device — print the card's name and power limit (nvidia-smi);
2. build — build every CUDA kernel from csrc/ and time the build;
3. kernels — hold each kernel against its plain PyTorch version at the
   ``base`` LM's shapes, time kernel, plain version and the PyTorch
   library call that computes the same function, beside the bound;
4. slice end to end — serve 3 requests through
   ``appsrc ! tensor_filter framework=torch model=...lm_serving:base !
   tensor_sink`` (float32, then ``custom=serve_dtype:bfloat16``), check the
   outputs and that every decode step went through the kernel;
5. teacher-forced parity — decode_step through the kernel and through the
   dense path on the same tokens; the logits agree at every step. Then the
   ``tiny`` entry's greedy tokens on the card equal the CPU path's.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and float32
# (non-tensor-core) flop/s; the kernel computes in float32
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# kernel vs plain version: both accumulate in float32 (a bfloat16 cache is
# widened exactly), so they differ only in summation order
KERNEL_RTOL, KERNEL_ATOL = 2e-4, 2e-5
# teacher-forced logits, kernel vs dense path, 12 layers deep: f32 differs by
# summation order only; with a bf16 cache one K/V value rounded the other
# way shifts a logit by about a bf16 ulp of its inputs
PARITY_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

BASE_SHAPE = dict(B=8, H=16, T=2048, D=64, block_k=128)
CHECK_POS = (0, 127, 128, 1023, 2047)
PROMPT, REQUESTS, STEPS = 512, 3, 64
# the decode steps of the main path attend at positions PROMPT..PROMPT+62;
# the kernel line is timed at the middle one
MAIN_POS = PROMPT + (STEPS - 1) // 2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, args_list, reps: int = 9, inner: int = 20) -> float:
    """Median per-call device time in ms over ``reps`` runs of ``inner``
    calls, cycling through ``args_list`` (distinct buffers, so the 50 MB L2
    holds none of them from the previous call, as in the decode loop where
    each layer reads its own cache). A device-side sleep queued ahead of
    each run lets the host enqueue all ``inner`` calls before the first
    starts, so the events time the card, not the Python wrapper."""
    for a in args_list[:3]:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)   # ~10 ms of clock cycles
        start.record()
        for i in range(inner):
            fn(*args_list[i % len(args_list)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def decode_bound_ms(B, H, D, pos, elt) -> tuple:
    """Least time for one decode attention: each valid key and value row,
    q and the output moved once; 4 flops per key element plus the exps."""
    n = pos + 1
    nbytes = 2 * B * H * n * D * elt + 2 * B * H * D * 4 + 4
    flops = 4 * B * H * n * D + B * H * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi


def phase_build(report: dict) -> None:
    from nnstreamer_tpu_torch.ops import build

    t0 = time.perf_counter()
    libs = build.build_kernels()
    report["build_s"] = time.perf_counter() - t0
    report["build_logs"] = build.build_logs
    print(f"build: {sorted(libs)} in {report['build_s']:.3f} s")
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def phase_kernels(report: dict, dev: torch.device) -> dict:
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_plain,
    )

    s = BASE_SHAPE
    B, H, T, D, bk = s["B"], s["H"], s["T"], s["D"], s["block_k"]
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, 1, D, device=dev, generator=gen)
    sweep = []
    timings = {}
    for dtype in (torch.float32, torch.bfloat16):
        elt = torch.tensor([], dtype=dtype).element_size()
        # enough distinct caches that one pass over them overflows the L2
        n_copies = 4 if dtype is torch.float32 else 6
        caches = [(torch.randn(B, H, T, D, device=dev, generator=gen).to(dtype),
                   torch.randn(B, H, T, D, device=dev, generator=gen).to(dtype))
                  for _ in range(n_copies)]
        k, v = caches[0]
        for pos in CHECK_POS:
            got = decode_attention(q, k, v, pos, bk)
            want = decode_attention_plain(q, k, v, pos, bk)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
            sweep.append({"dtype": str(dtype), "pos": pos, "max_abs_err": err})
        pos = MAIN_POS
        pos_t = torch.full((1,), pos, dtype=torch.int32, device=dev)
        args = [(q, ck, cv, pos_t, bk) for ck, cv in caches]
        q_lib = q.to(dtype)
        lib_args = [(q_lib, ck[:, :, :pos + 1], cv[:, :, :pos + 1])
                    for ck, cv in caches]
        err = (decode_attention(q, k, v, pos_t, bk)
               - decode_attention_plain(q, k, v, pos_t, bk)).abs().max().item()
        bound, bound_by = decode_bound_ms(B, H, D, pos, elt)
        timings[str(dtype)] = {
            "pos": pos, "max_abs_err": err,
            "ms": time_ms(decode_attention, args),
            "plain_ms": time_ms(decode_attention_plain, args),
            "library_ms": time_ms(F.scaled_dot_product_attention, lib_args),
            "bound_ms": bound, "bound_by": bound_by,
        }
        print(f"decode_attention {dtype}: " + json.dumps(timings[str(dtype)]))
        del caches, args, lib_args
    report["kernel_sweep"] = sweep
    report["kernel_timings"] = timings
    print(f"kernel vs plain at B={B} H={H} T={T} D={D} block_k={bk}: "
          f"max |err| {max(r['max_abs_err'] for r in sweep):.3e} over "
          f"{len(sweep)} cases (rtol {KERNEL_RTOL}, atol {KERNEL_ATOL})")
    return timings


def serve(custom: str, prompts) -> dict:
    """Drive the launch line on ``prompts``; return outputs, launches and
    times."""
    from nnstreamer_tpu_torch.core import MessageType
    from nnstreamer_tpu_torch.ops.decode_attention import decode_attention
    from nnstreamer_tpu_torch.runtime.parse import parse_launch

    B, P = prompts[0].shape
    extra = f" custom={custom}" if custom else ""
    pipe = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,"
        f"dimensions={P}:{B},types=int32 "
        "! tensor_filter framework=torch "
        f"model=nnstreamer_tpu_torch.models.lm_serving:base{extra} name=f "
        f"! tensor_sink name=out max-stored={len(prompts)}")
    outs, t_out = [], []

    def on_data(buf):
        t = buf.tensors[0]
        torch.cuda.synchronize()
        t_out.append(time.perf_counter())
        outs.append(t)

    pipe.get("out").connect(on_data)
    decode_attention.launches = 0
    t0 = time.perf_counter()
    pipe.play()
    try:
        src = pipe.get("in")
        for p in prompts:
            src.push_buffer(p)
        src.end_of_stream()
        msg = pipe.wait(timeout=600)
    finally:
        pipe.stop()
    launches = decode_attention.launches
    if msg.type is not MessageType.EOS:
        fail(f"pipeline ({custom or 'float32'}): {msg}")
    return {"outs": outs, "launches": launches, "t0": t0, "t_out": t_out}


def phase_slice(report: dict) -> int:
    from nnstreamer_tpu_torch.models.lm_serving import base

    vocab = base.cfg.vocab
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, (8, PROMPT)).astype(np.int32)
               for _ in range(REQUESTS)]
    want_launches = REQUESTS * (STEPS - 1) * base.cfg.layers
    main_launches = None
    report["slice"] = {}
    for custom in ("", "serve_dtype:bfloat16"):
        r = serve(custom, prompts)
        name = custom or "float32"
        if len(r["outs"]) != REQUESTS:
            fail(f"{name}: {len(r['outs'])} outputs for {REQUESTS} requests")
        for p, out in zip(prompts, r["outs"]):
            if not (out.is_cuda and out.dtype is torch.int32
                    and tuple(out.shape) == (8, PROMPT + STEPS)):
                fail(f"{name}: output {out.dtype} {tuple(out.shape)} on "
                     f"{out.device}")
            host = out.cpu().numpy()
            if not np.array_equal(host[:, :PROMPT], p):
                fail(f"{name}: prompt not echoed unchanged")
            if host.min() < 0 or host.max() >= vocab:
                fail(f"{name}: tokens outside [0, {vocab})")
        if r["launches"] != want_launches:
            fail(f"{name}: decode kernel launched {r['launches']} times, "
                 f"expected {want_launches} ({REQUESTS} requests x "
                 f"{STEPS - 1} steps x {base.cfg.layers} layers)")
        gen_tokens = 8 * STEPS
        t_out = r["t_out"]
        steady = (REQUESTS - 1) * gen_tokens / (t_out[-1] - t_out[0])
        first_s = t_out[0] - r["t0"]
        report["slice"][name] = {
            "launches": r["launches"],
            "tokens_per_s_steady": steady,
            "request_s_steady": (t_out[-1] - t_out[0]) / (REQUESTS - 1),
            "first_request_s_incl_model_build": first_s,
            "total_s": t_out[-1] - r["t0"],
        }
        print(f"slice {name}: {REQUESTS} x (8, {PROMPT}) -> (8, "
              f"{PROMPT + STEPS}) int32; kernel launches {r['launches']}; "
              f"{steady:.1f} generated tokens/s (requests 2-3); first "
              f"request {first_s:.3f} s incl. model build")
        if main_launches is None:
            main_launches = r["launches"]
    return main_launches


def phase_parity(report: dict, dev: torch.device) -> None:
    from nnstreamer_tpu_torch.models.decoding import (
        decode_step,
        init_cache,
        prefill,
    )
    from nnstreamer_tpu_torch.models.lm_serving import base

    cfg_k = base.cfg
    cfg_d = replace(cfg_k, decode_attn="dense")
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(
        rng.integers(0, cfg_k.vocab, (8, PROMPT)).astype(np.int32)).to(dev)
    forced = torch.from_numpy(
        rng.integers(0, cfg_k.vocab, (8, 16)).astype(np.int32)).to(dev)
    report["parity"] = {}
    for dtype in (torch.float32, torch.bfloat16):
        entry = replace(base, serve_dtype=None if dtype is torch.float32
                        else "bfloat16")
        params = entry.build_params(dev)
        with torch.inference_mode():
            caches = {}
            for cfg in (cfg_k, cfg_d):
                _, caches[cfg.decode_attn], pos = prefill(
                    cfg, params, prompt, init_cache(cfg, 8, dtype, dev))
            worst = 0.0
            for i in range(forced.shape[1]):
                lk, caches["kernel"] = decode_step(
                    cfg_k, params, forced[:, i], pos + i, caches["kernel"])
                ld, caches["dense"] = decode_step(
                    cfg_d, params, forced[:, i], pos + i, caches["dense"])
                err = (lk - ld).abs().max().item()
                worst = max(worst, err)
                if not err <= PARITY_ATOL[dtype]:
                    fail(f"parity {dtype} step {i}: max |logit diff| {err} "
                         f"> {PARITY_ATOL[dtype]}")
        report["parity"][str(dtype)] = worst
        print(f"teacher-forced parity {dtype}: {forced.shape[1]} steps at "
              f"base width, max |logit diff| {worst:.3e} "
              f"(atol {PARITY_ATOL[dtype]})")
        del params, caches

    # small input against the CPU path, which tests/test_torch_*.py hold
    # token-exact against nnstreamer_tpu: the tiny entry's greedy tokens on
    # the card (through the kernel) equal the CPU's on the same weights
    from nnstreamer_tpu_torch.models.decoding import make_generate
    from nnstreamer_tpu_torch.models.lm_serving import tiny

    cpu_params = tiny.build_params(torch.device("cpu"))
    dev_params = {k: (v.to(dev) if k != "blocks" else
                      [{n: t.to(dev) for n, t in b.items()} for b in v])
                  for k, v in cpu_params.items()}
    small = torch.from_numpy(rng.integers(0, tiny.cfg.vocab, (4, 6))
                             .astype(np.int32))
    gen = make_generate(tiny.cfg)
    with torch.inference_mode():
        want = gen(cpu_params, small, 8)
        got = gen(dev_params, small.to(dev), 8).cpu()
    if not torch.equal(got, want):
        fail(f"tiny greedy tokens on the card differ from the CPU's:\n"
             f"{got}\n{want}")
    report["parity"]["tiny_tokens_equal_cpu"] = True
    print("tiny entry: greedy tokens on the card equal the CPU's")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    try:
        import nnstreamer_tpu_torch
    except ImportError as e:
        fail(f"the nnstreamer_tpu_torch package is not beside this script: {e}")
    if ROOT not in Path(nnstreamer_tpu_torch.__file__).resolve().parents:
        fail("nnstreamer_tpu_torch was imported from outside this checkout")
    # full float32 products in both the kernel checks and the model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    report: dict = {}
    dev = torch.device("cuda:0")
    report["device"] = phase_device()
    phase_build(report)
    timings = phase_kernels(report, dev)
    launches = phase_slice(report)
    phase_parity(report, dev)

    main_t = timings[str(torch.float32)]
    kernels = [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "nnstreamer_tpu_torch/csrc/decode_attention.cu",
        "replaces": "nnstreamer_tpu/ops/pallas_decode.py:83",
        "launches": launches,
        "max_abs_err": main_t["max_abs_err"],
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
    }]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
