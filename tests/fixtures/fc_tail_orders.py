"""Summation orders tried for the FULLY_CONNECTED's last 41 columns
(960-1000) at batch 4 (ROADMAP §C, C1).

Runs the reference importer's fake-quant forward of the int8 fixture on
its 4 seeded frames under ``jax.jit``, keeps the FC's ``jnp.matmul``
operands and result, and counts, for each candidate order, the values of
the 4 × 41 tail that differ from the jitted result. Columns 0-959 under
their known order (one FMA chain per 512-step block of K, the blocks
added in order) are printed first as a check of the harness: 0.

Candidates: XLA:CPU's tiled LLVM IR GEMM for small M accumulates each
output tile over K in float32 — one chain in K order whatever its K tile —
with ``fmuladd`` contracted to an FMA or, if it is not, a multiply and an
add each rounded; so one FMA chain, 2 and 4 chains and 512-step blocks
(``ops/fma_gemm.py``), and the multiply-then-add forms: one chain, K
blocks of 8-512 added in order, 2-16 chains added pairwise.

Eigen GEBP's remainder paths (``peeled_forms``): with 16-float packets the
3-packet path takes rows 0-959 of the transposed product, the 2-packet
path 960-991, the half-packet path 992-999 and the scalar path 1000. In
each K block (``kc`` steps) the k loop is peeled by 8 and alternates two
accumulator sets: even steps FMA into C, odd ones into D, and C + D is
added after the peeled loop; the block's sum is added to the result in
block order. Tried per sub-range, for kc = 256, 320, 512, 640 and 1280,
with the two sets split by step parity, by halves of the 8-step group, or
as four sets (k mod 4) added pairwise.

    python tests/fixtures/fc_tail_orders.py     # ~1 min on the CPU, JAX
"""
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

import nnstreamer_tpu.models.tflite_import as R  # noqa: E402
import test_torch_tflite_fma as T  # noqa: E402
from nnstreamer_tpu_torch.ops.fma_gemm import fma_gemm_plain  # noqa: E402


def fc_operands():
    """(a (4, 1280), b (1280, 1001), jitted a @ b) of the fixture's FC."""
    rfn, _, _ = R.load_tflite(str(T._MODEL), {
        "quantized_exec": "fake-quant", "batch": "4"})
    orig, seen = jnp.matmul, {}

    def mm(a, b, **kw):
        out = orig(a, b, **kw)
        if b.shape[-1] == 1001:
            seen.update(a=a, b=b, mm=out)
        return out

    def run(x):
        jnp.matmul = mm
        try:
            rfn(x)
        finally:
            jnp.matmul = orig
        return seen["a"], seen["b"], seen["mm"]

    return (np.array(v) for v in jax.jit(run)(T._frames4()))


def mul_add(a, b, chains=1, kblock=0):
    """Float32 multiply then add, each rounded: ``chains`` chains over
    k = c, c + chains, ... added pairwise, or chains over ``kblock``-step
    blocks added in order."""
    K = a.shape[1]
    if kblock:
        tot = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for k0 in range(0, K, kblock):
            tot = (tot + mul_add(a[:, k0:k0 + kblock],
                                 b[k0:k0 + kblock])).astype(np.float32)
        return tot
    ch = np.zeros((chains, a.shape[0], b.shape[1]), np.float32)
    for k in range(K):
        ch[k % chains] = (ch[k % chains]
                          + a[:, k:k + 1] * b[k:k + 1]).astype(np.float32)
    while len(ch) > 1:
        ch = np.stack([(ch[i] + ch[i + 1]).astype(np.float32)
                       for i in range(0, len(ch), 2)])
    return ch[0]


def peeled(a, b, kc, split):
    """One K block at a time: the block's steps split into accumulator
    sets by ``split(k)`` (k counted from the block's start), each an FMA
    chain, the sets added pairwise in set order; the blocks' sums added
    to the result in block order."""
    K = a.shape[1]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    out = None
    for k0 in range(0, K, kc):
        ks = np.arange(k0, min(K, k0 + kc))
        sets = {}
        for k in ks:
            sets.setdefault(split(k - k0), []).append(k)
        parts = [fma_gemm_plain(ta[:, idx], tb[idx])
                 for _, idx in sorted(sets.items())]
        while len(parts) > 1:
            parts = [parts[i] + parts[i + 1] if i + 1 < len(parts)
                     else parts[i] for i in range(0, len(parts), 2)]
        out = parts[0] if out is None else out + parts[0]
    return out.numpy()


SPLITS = {"parity (C even, D odd)": lambda k: k % 2,
          "halves of 8 (C 0-3, D 4-7)": lambda k: (k % 8) // 4,
          "four sets (k mod 4)": lambda k: k % 4}
SUBRANGES = {"2-packet 960-991": (0, 32), "half-packet 992-999": (32, 40),
             "scalar 1000": (40, 41)}


def peeled_forms(a, tail, w):
    """Rows of (form, mismatches per sub-range) for the peeled orders."""
    rows = []
    for kc in (256, 320, 512, 640, 1280):
        for sname, split in SPLITS.items():
            got = peeled(a, tail, kc, split)
            miss = {r: int((got[:, c0:c1] != w[:, c0:c1]).sum())
                    for r, (c0, c1) in SUBRANGES.items()}
            rows.append((f"peeled by 8, kc {kc}, {sname}", miss))
    return rows


def main() -> None:
    a, b, want = fc_operands()
    head = fma_gemm_plain(torch.from_numpy(a), torch.from_numpy(
        b[:, :960].copy()), kblock=512).numpy()
    print(f"columns 0-959, FMA chains over 512-step blocks: "
          f"{int((head != want[:, :960]).sum())} of {head.size} differ")
    tail, w = b[:, 960:].copy(), want[:, 960:]
    ta, tb = torch.from_numpy(a), torch.from_numpy(tail)
    rows = [("fma, one chain", fma_gemm_plain(ta, tb).numpy()),
            ("fma, 2 chains", fma_gemm_plain(ta, tb, chains=2).numpy()),
            ("fma, 4 chains", fma_gemm_plain(ta, tb, chains=4).numpy()),
            ("fma, 512-step blocks", fma_gemm_plain(ta, tb,
                                                    kblock=512).numpy()),
            ("mul+add, one chain", mul_add(a, tail))]
    rows += [(f"mul+add, {k}-step blocks", mul_add(a, tail, kblock=k))
             for k in (8, 16, 32, 64, 128, 256, 512)]
    rows += [(f"mul+add, {c} chains pairwise", mul_add(a, tail, chains=c))
             for c in (2, 4, 8, 16)]
    for name, got in rows:
        print(f"columns 960-1000, {name}: {int((got != w).sum())} of "
              f"{w.size} differ")
    sizes = {r: 4 * (c1 - c0) for r, (c0, c1) in SUBRANGES.items()}
    for name, miss in peeled_forms(a, tail, w):
        print(f"columns 960-1000, {name}: " + ", ".join(
            f"{r} {n} of {sizes[r]}" for r, n in miss.items()))


if __name__ == "__main__":
    main()
