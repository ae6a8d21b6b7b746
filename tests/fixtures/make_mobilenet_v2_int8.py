"""Regenerate mobilenet_v2_1.0_224_int8.tflite.

A full-width MobileNet-v2 (width 1.0, 224x224x3 input, 1001 classes, no
softmax) with random weights from seed 0, converted full-integer with int8
input and output: the shape of upstream NNStreamer's flagship model
(``mobilenet_v2_1.0_224_quant.tflite``) in the modern per-channel int8
style. Keras' default BatchNorm statistics would collapse every output to
one value, so each BatchNorm's moving statistics are first set from 16
seeded frames, and the Dense layer gets a seeded bias. The converter's
representative dataset is 8 more seeded frames.

The generator asserts the op list and at least 100 distinct output values
on a seeded frame, so a fixture whose outputs collapsed is caught.

Run:  python tests/fixtures/make_mobilenet_v2_int8.py
"""
import collections
import os

import numpy as np
import tensorflow as tf

WANT_OPS = {"CONV_2D": 35, "DEPTHWISE_CONV_2D": 17, "ADD": 10, "MEAN": 1,
            "FULLY_CONNECTED": 1}


def frames(rng, n):
    """Smooth random images in [-1, 1] with per-channel tints."""
    u = rng.random((n, 224, 224, 1)) * rng.random((n, 1, 1, 3))
    x = np.clip(u + rng.normal(0, 0.1, (n, 224, 224, 3)), 0, 1)
    return (x * 2 - 1).astype(np.float32)


def build():
    tf.keras.utils.set_random_seed(0)
    model = tf.keras.applications.MobileNetV2(
        input_shape=(224, 224, 3), alpha=1.0, weights=None, classes=1001,
        classifier_activation=None)
    rng = np.random.default_rng(0)
    calib = frames(rng, 16)
    for layer in model.layers:
        if isinstance(layer, tf.keras.layers.BatchNormalization):
            layer.momentum = 0.0
    model(calib, training=True)  # moving stats := these frames' stats
    dense = model.layers[-1]
    w, b = dense.get_weights()
    dense.set_weights([w, rng.normal(0, 0.5, b.shape).astype(np.float32)])
    rep_frames = frames(rng, 8)

    conv = tf.lite.TFLiteConverter.from_keras_model(model)
    conv.optimizations = [tf.lite.Optimize.DEFAULT]

    def rep():
        for i in range(len(rep_frames)):
            yield [rep_frames[i:i + 1]]

    conv.representative_dataset = rep
    conv.target_spec.supported_ops = [tf.lite.OpsSet.TFLITE_BUILTINS_INT8]
    conv.inference_input_type = tf.int8
    conv.inference_output_type = tf.int8
    return conv.convert()


def check(blob: bytes) -> None:
    it = tf.lite.Interpreter(
        model_content=blob,
        experimental_op_resolver_type=(
            tf.lite.experimental.OpResolverType.BUILTIN_WITHOUT_DEFAULT_DELEGATES))
    it.allocate_tensors()
    ops = collections.Counter(d["op_name"] for d in it._get_ops_details())
    assert dict(ops) == WANT_OPS, dict(ops)
    ind, outd = it.get_input_details()[0], it.get_output_details()[0]
    assert ind["dtype"] == np.int8 and outd["dtype"] == np.int8
    assert tuple(outd["shape"]) == (1, 1001)
    x = np.random.default_rng(1).integers(-128, 128, (1, 224, 224, 3))
    it.set_tensor(ind["index"], x.astype(np.int8))
    it.invoke()
    distinct = len(np.unique(it.get_tensor(outd["index"])))
    assert distinct >= 100, f"collapsed fixture: {distinct} distinct outputs"


def main() -> None:
    blob = build()
    check(blob)
    out = os.path.join(os.path.dirname(__file__),
                       "mobilenet_v2_1.0_224_int8.tflite")
    with open(out, "wb") as fh:
        fh.write(blob)
    print(f"wrote {out} ({len(blob)} bytes)")


if __name__ == "__main__":
    main()
