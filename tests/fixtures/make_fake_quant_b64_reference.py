"""Regenerate mobilenet_v2_1.0_224_int8_fake_quant_b64.npz.

nnstreamer_tpu's jitted fake-quant forward (``quantized_exec:fake-quant``,
``batch:64``, ``precision`` left at ``highest``) of
``mobilenet_v2_1.0_224_int8.tflite`` on one batch of 64 seeded frames,
made as ``chip_smoke.py::tf_host_frames`` makes its first batch: 64 draws
of ``numpy.random.default_rng(0).integers(0, 127, (1, 224, 224, 3))``
as int8, in order. The file keeps the int8 output (64, 1001), the seed,
the bounds and the options, so a run without JAX (the card's) can hold
the port's output against the reference's.

Run:  python tests/fixtures/make_fake_quant_b64_reference.py
"""
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
MODEL = HERE / "mobilenet_v2_1.0_224_int8.tflite"
OUT = HERE / "mobilenet_v2_1.0_224_int8_fake_quant_b64.npz"
SEED, LOW, HIGH, BATCH = 0, 0, 127, 64
OPTIONS = {"quantized_exec": "fake-quant", "batch": str(BATCH)}


def frames() -> np.ndarray:
    rng = np.random.default_rng(SEED)
    return np.concatenate([rng.integers(LOW, HIGH, (1, 224, 224, 3))
                           .astype(np.int8) for _ in range(BATCH)])


def reference_output() -> np.ndarray:
    import jax

    sys.path.insert(0, str(HERE.parents[1]))
    from nnstreamer_tpu.models.tflite_import import load_tflite

    fn, _, _ = load_tflite(str(MODEL), dict(OPTIONS))
    return np.asarray(jax.jit(fn)(frames())[0])


def main() -> None:
    out = reference_output()
    assert out.shape == (BATCH, 1001) and out.dtype == np.int8, out.shape
    np.savez_compressed(OUT, out=out, seed=SEED, low=LOW, high=HIGH,
                        options=json.dumps(OPTIONS))
    print(f"wrote {OUT} ({OUT.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
