"""Measure every tile of the two fake-quant kernels at the shapes of a
batch-64 fake-quant forward of the int8 MobileNet-v2 fixture, on the card.

``csrc/fma_gemm.cu`` (``TUNED``) and ``ops/depthwise_fma.py``
(``_TUNED``) keep the fastest tile this prints for each of those shapes;
other shapes take the tile their models pick. Every tile gives the same
bits (each output's FMA chain is the same), so the choice moves only time.
Each candidate is timed with CUDA events over launches queued behind a
device sleep, on three sets of seeded operands (the time of a launch, not
of the Python call), and checked bit for bit against the plain version
once.

Run on the machine with the card, from the root of the checkout::

    python -m nnstreamer_tpu_torch.ops.tune_fake_quant [--batch 64]

It prints the card's name and power limit, a line per shape, the table
rows to keep, and writes every time to ``chiprun_out/tune_fake_quant.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from collections import Counter
from pathlib import Path

import torch

from . import depthwise_fma as DW
from . import fma_gemm as FG

ROOT = Path(__file__).resolve().parents[2]
MODEL = ROOT / "tests" / "fixtures" / "mobilenet_v2_1.0_224_int8.tflite"


def forward_shapes(batch: int):
    """({(M, K, N, chains, kblock): launches}, {(H, W, C, stride):
    launches}) of a fake-quant forward of the fixture at ``batch``, as the
    importer routes its ops to the two kernels."""
    from ..models.tflite_import import (DEPTHWISE_FMA_SHAPES, FMA_ORDERS,
                                        MEAN_FMA_SHAPES, read_model)

    steps, tensors, *_ = read_model(str(MODEL))
    gemms, dws = Counter(), Counter()
    for code, cfg, ins, outs in steps:
        if code == "CONV_2D":
            oc, kh, kw, ic = tensors[ins[1]].shape
            _, h, w, _ = tensors[ins[0]].shape
            _, oh, ow, _ = tensors[outs[0]].shape
            order = FMA_ORDERS.get((batch, h, w, kh, kw, *cfg["strides"],
                                    ic, oc))
            if order:
                gemms[(batch * oh * ow, kh * kw * ic, oc, *order)] += 1
        elif code == "FULLY_CONNECTED":
            n, k = tensors[ins[1]].shape
            order = FMA_ORDERS.get((batch, 1, 1, 1, 1, 1, 1, k, n))
            if order:
                gemms[(batch, k, n, *order)] += 1
        elif code == "MEAN":
            _, h, w, c = tensors[ins[0]].shape
            if (batch, h, w, c) in MEAN_FMA_SHAPES:
                gemms[(batch * c, h * w, 1, 1, 0)] += 1
        elif code == "DEPTHWISE_CONV_2D":
            _, kh, kw, oc = tensors[ins[1]].shape
            _, h, w, c = tensors[ins[0]].shape
            if (batch, h, w, kh, kw, *cfg["strides"], c,
                    oc) in DEPTHWISE_FMA_SHAPES:
                dws[(h, w, c, cfg["strides"][0])] += 1
    return dict(gemms), dict(dws)


def time_ms(fn, args_list, reps: int = 3, inner: int = 6) -> float:
    """Median device ms a call over ``reps`` runs of ``inner`` calls queued
    behind a ~2 ms device sleep, cycling through ``args_list``."""
    for a in args_list[:2]:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        start.record()
        for i in range(inner):
            fn(*args_list[i % len(args_list)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def tune_gemms(gemms: dict, gen: torch.Generator) -> dict:
    lib = FG._kernel()
    table = FG.tile_table()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for (M, K, N, chains, kblock), count in sorted(gemms.items()):
        blocks = kblock > 0 and K > kblock
        # the importer's layout: rows of K or N that is not a multiple of 4
        # on a padded pitch
        args = []
        for _ in range(3):
            a, b = FG.padded_rows(M, K, "cuda"), FG.padded_rows(K, N, "cuda")
            a.copy_(torch.randn(M, K, device="cuda", generator=gen))
            b.copy_(torch.randn(K, N, device="cuda", generator=gen))
            args.append((a, b))
        want = FG.fma_gemm_plain(*args[0], chains, kblock)

        def run(a, b, i):
            o = torch.empty(M, N, device="cuda")
            err = lib.nns_fma_gemm(a.data_ptr(), b.data_ptr(), o.data_ptr(),
                                   M, K, N, a.stride(0), b.stride(0), chains,
                                   kblock, i, stream)
            if err:
                raise RuntimeError(f"tile {i}: CUDA error {err}")
            return o
        times = {}
        for i, t in enumerate(table):
            if t["chains"] != chains or bool(t["kblocks"]) != blocks:
                continue
            if not torch.equal(run(*args[0], i), want):
                raise RuntimeError(f"tile {i} {t} differs from the plain "
                                   f"version at ({M}, {K}, {N})")
            times[i] = time_ms(lambda a, b, i=i: run(a, b, i), args)
        pick = FG.tile_for(M, K, N, chains, kblock)["index"]
        best = min(times, key=times.get)
        matmul = time_ms(lambda a, b: torch.matmul(a, b), args)
        out[f"{M},{K},{N},{chains},{kblock}"] = {
            "count": count, "times": times, "pick": pick, "best": best,
            "matmul_ms": matmul}
        t = table[best]
        print(f"fma_gemm ({M}, {K}, {N}) chains {chains} kblock {kblock} "
              f"x{count}: best tile {best} {t} {times[best]:.6f} ms; "
              f"picked {pick} {times[pick]:.6f} ms; matmul {matmul:.6f} ms",
              flush=True)
    return out


def _dw_candidates(n, oh, c, stride, sms):
    picked = DW.tile_for(n, oh, oh, c, stride, sms)
    cands = {tuple(picked[f] for f in ("th", "tw", "cb", "rows", "slots"))}
    sizes = sorted({oh, *(d for d in (28, 16, 14, 8, 7) if d < oh)})
    for th in sizes:
        for tw in sizes:
            for cb in (16, 32, 48, 64, 72, 96, 160):
                if c % cb or cb > c:
                    continue
                for rows in {th, -(-th // 2)}:
                    in_h, in_w = (th - 1) * stride + 3, (tw - 1) * stride + 3
                    thr = cb // 4 * tw * -(-th // rows)
                    for slots in DW._SLOTS:
                        if 64 <= thr <= 512 and slots * in_h * in_w * cb * \
                                4 <= 227 * 1024:
                            cands.add((th, tw, cb, rows, slots))
    return picked, sorted(cands)


def tune_depthwise(dws: dict, batch: int, gen: torch.Generator) -> dict:
    kern = DW._kernel()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for (h, w, c, s), count in sorted(dws.items()):
        oh, ow = -(-h // s), -(-w // s)
        pt = pl = 1 if s == 1 else 0
        pads = ((pt, (oh - 1) * s + 3 - h - pt), (pl, (ow - 1) * s + 3 - w
                                                  - pl))
        scale = 0.0235294122248888 if s == 1 else None
        args = []
        for _ in range(3):
            k = torch.randint(-255, 256, (batch, h, w, c), device="cuda",
                              generator=gen).float()
            x = k * torch.tensor(0.0235294122248888, device="cuda")
            args.append((x, torch.randn(1, 3, 3, c, device="cuda",
                                        generator=gen) / 3))
        want = DW.depthwise_fma_plain(*args[0], (s, s), (1, 1), pads,
                                      (oh, ow), scale)
        picked, cands = _dw_candidates(batch, oh, c, s, sms)

        def run(x, wt, t):
            o = torch.empty(batch, oh, ow, c, device="cuda")
            f = DW.tile_shape(batch, oh, ow, c, s, sms, *t)
            err = kern(x.data_ptr(), wt.data_ptr(), o.data_ptr(), batch, h,
                       w, c, oh, ow, s, pt, pl, 4 if scale else -1,
                       scale or 0.0, *t, f["grid"], stream)
            if err:
                raise RuntimeError(f"tile {t}: CUDA error {err}")
            return o
        times = {}
        for t in cands:
            if not torch.equal(run(*args[0], t), want):
                raise RuntimeError(f"depthwise tile {t} differs from the "
                                   f"plain version at {(h, w, c, s)}")
            times[t] = time_ms(lambda x, wt, t=t: run(x, wt, t), args)
        pick = tuple(picked[f] for f in ("th", "tw", "cb", "rows", "slots"))
        best = min(times, key=times.get)
        out[f"{h},{w},{c},{s}"] = {
            "count": count, "pick": list(pick), "best": list(best),
            "times": {",".join(map(str, k)): v for k, v in times.items()}}
        print(f"depthwise_fma ({h}, {w}, {c}, stride {s}) x{count}: best "
              f"{best} {times[best]:.6f} ms; picked {pick} "
              f"{times[pick]:.6f} ms; {len(times)} tiles", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--only", choices=("fma_gemm", "depthwise_fma"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_fake_quant: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    gemms, dws = forward_shapes(args.batch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {"card": smi, "batch": args.batch}
    if args.only != "depthwise_fma":
        report["fma_gemm"] = tune_gemms(gemms, gen)
    if args.only != "fma_gemm":
        report["depthwise_fma"] = tune_depthwise(dws, args.batch, gen)
    for name in ("fma_gemm", "depthwise_fma"):
        if name not in report:
            continue
        res = report[name]
        best = sum(r["count"] * r["times"][
            r["best"] if name == "fma_gemm" else ",".join(
                map(str, r["best"]))] for r in res.values())
        print(f"{name}: a forward's launches {best:.6f} ms at the best "
              "tiles", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "tune_fake_quant.json").write_text(json.dumps(report, indent=1,
                                                         default=str))


if __name__ == "__main__":
    main()
