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

oneDNN's and XNNPACK's f32 GEMM microkernel orders (``library_forms``):
both broadcast one A value a step into an FMA chain per output, in K order
from zero (XNNPACK from the bias, here none), which is the one chain
above; what differs is how K is cut and how partial sums meet. Tried:
one FMA chain in reversed K order, and reversed inside 512-step blocks
added in order (a kernel walking a packed panel backwards); oneDNN's K
blocks accumulated into C in reversed block order; XNNPACK's ``c4``/``c8``
kernels (4 or 8 lanes along K, each lane an FMA chain over k = j mod c,
the lanes reduced by ``hadd`` pairs, then the 128-bit halves); a float64
accumulation rounded once (a library's reference path); and numpy's
pairwise sum of the float32 products (8 accumulators unrolled, blocks of
128 halved recursively).

The operands first (``operands_check``): the same ``jnp.matmul`` jitted
alone on the captured operands, with ``b`` a parameter and with ``b`` a
constant (the full forward folds the dequantized weights into a constant
f32[1280, 1001] and feeds it and the MEAN's fusion to one plain ``dot``;
``jax.jit(fn).lower(x).compile().as_text()`` shows it), must give the
forward's bits in all 1001 columns. It does, and also with
``XLA_FLAGS=--xla_cpu_multi_thread_eigen=false``: the operands are the
forward's, and the tail's order is inside XLA:CPU's dot itself, on one
thread too.

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


def _fma_chain(a, b, ks):
    """One float32 FMA chain over the steps ``ks``, in that order."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float64)
    ta, tb = torch.from_numpy(a).double(), torch.from_numpy(b).double()
    for k in ks:
        # an FMA: the exact product plus the running sum, rounded once
        acc = (acc + ta[:, k:k + 1] * tb[k:k + 1]).float().double()
    return acc.float().numpy()


def _lanes(a, b, c):
    """XNNPACK's ``c``-lane kernels: lane j an FMA chain over k = j mod c,
    reduced by hadd pairs ((l0+l1)+(l2+l3)) and then the halves."""
    K = a.shape[1]
    lanes = [_fma_chain(a, b, range(j, K, c)) for j in range(c)]
    while len(lanes) > 1:
        lanes = [(lanes[i] + lanes[i + 1]).astype(np.float32)
                 for i in range(0, len(lanes), 2)]
    return lanes[0]


def _pairwise(x):
    """numpy's pairwise sum along axis 0 of float32 ``x`` (8 accumulators
    unrolled below 128 terms, halves above)."""
    n = x.shape[0]
    if n < 8:
        out = x[0].copy()
        for i in range(1, n):
            out = (out + x[i]).astype(np.float32)
        return out
    if n <= 128:
        r = [x[i].copy() for i in range(8)]
        for i in range(8, n - n % 8, 8):
            for j in range(8):
                r[j] = (r[j] + x[i + j]).astype(np.float32)
        res = (((r[0] + r[1]).astype(np.float32)
                + (r[2] + r[3]).astype(np.float32)).astype(np.float32)
               + ((r[4] + r[5]).astype(np.float32)
                  + (r[6] + r[7]).astype(np.float32)).astype(np.float32)
               ).astype(np.float32)
        for i in range(n - n % 8, n):
            res = (res + x[i]).astype(np.float32)
        return res
    half = (n // 2) - (n // 2) % 8
    return (_pairwise(x[:half]) + _pairwise(x[half:])).astype(np.float32)


def library_forms(a, tail):
    """(form, result) for oneDNN's and XNNPACK's orders (module docstring)."""
    K = a.shape[1]
    rows = [("reversed K, one FMA chain", _fma_chain(a, tail,
                                                     range(K - 1, -1, -1)))]
    blocks = [_fma_chain(a, tail, range(min(K, k0 + 512) - 1, k0 - 1, -1))
              for k0 in range(0, K, 512)]
    tot = blocks[0]
    for blk in blocks[1:]:
        tot = (tot + blk).astype(np.float32)
    rows.append(("reversed inside 512-step blocks, blocks in order", tot))
    for kc in (256, 512):
        parts = [_fma_chain(a, tail, range(k0, min(K, k0 + kc)))
                 for k0 in range(0, K, kc)][::-1]
        tot = parts[0]
        for p in parts[1:]:
            tot = (tot + p).astype(np.float32)
        rows.append((f"{kc}-step blocks added in reversed order", tot))
    rows += [(f"XNNPACK c{c} lanes, hadd reduction", _lanes(a, tail, c))
             for c in (4, 8)]
    rows.append(("float64 sum rounded once",
                 (a.astype(np.float64) @ tail.astype(np.float64))
                 .astype(np.float32)))
    prods = (a[:, :, None] * tail[None]).astype(np.float32)   # (M, K, N)
    rows.append(("numpy pairwise sum of float32 products",
                 _pairwise(np.moveaxis(prods, 1, 0))))
    return rows


def operands_check(a, b, want):
    """Rows of (form, head mismatches, tail mismatches) for the FC's dot
    jitted alone on the captured operands."""
    bc = jnp.asarray(b)
    rows = [("jitted dot alone, b a parameter", jax.jit(
                lambda x, y: jnp.matmul(x, y, precision="highest"))(a, b)),
            ("jitted dot alone, b a constant", jax.jit(
                lambda x: jnp.matmul(x, bc, precision="highest"))(a))]
    return [(name, int((np.asarray(v)[:, :960] != want[:, :960]).sum()),
             int((np.asarray(v)[:, 960:] != want[:, 960:]).sum()))
            for name, v in rows]


def main() -> None:
    a, b, want = fc_operands()
    for name, head, tail in operands_check(a, b, want):
        print(f"{name}: columns 0-959 {head} of {4 * 960} differ, "
              f"columns 960-1000 {tail} of {4 * 41} differ")
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
    rows = library_forms(a, tail)
    for name, got in rows:
        print(f"columns 960-1000, {name}: {int((got != w).sum())} of "
              f"{w.size} differ")
    sizes = {r: 4 * (c1 - c0) for r, (c0, c1) in SUBRANGES.items()}
    for name, miss in peeled_forms(a, tail, w):
        print(f"columns 960-1000, {name}: " + ", ".join(
            f"{r} {n} of {sizes[r]}" for r, n in miss.items()))


if __name__ == "__main__":
    main()
