"""``tensor_trainer`` model config of the transformer LM: pass this file's
path as ``model-config``.

    appsrc caps=other/tensors,format=static,num_tensors=2,
        dimensions=512.512,types=int32.int32
      ! tensor_trainer framework=optax model-config=<this file>
        custom=batch:8,optimizer:adamw num-training-samples=32 epochs=2

Each frame is (input tokens (S,), target tokens (S,)) — the targets the
inputs shifted by one. ``init`` builds the ``lm_serving`` entry's
parameters from seed 0 on the trainer's device; ``loss_fn`` is
models/transformer.py's ``lm_loss`` (the train step's objective: the
next-token cross entropy plus, for an MoE entry, the balance term) and
reports the top-1 accuracy. The entry is models/lm_serving.py's
``base``, the LM's full width.
"""
from nnstreamer_tpu_torch.models import lm_serving
from nnstreamer_tpu_torch.models.transformer import (forward, init_params,
                                                     lm_loss)

CFG = lm_serving.base.cfg


def init(generator, example_inputs):
    return init_params(CFG, seed=0, device=example_inputs[0].device)


def loss_fn(params, inputs, labels):
    logits, aux = forward(CFG, params, inputs[0], return_aux=True)
    targets = labels[0].long()
    loss = lm_loss(CFG, logits, targets, aux)
    accuracy = (logits.argmax(-1) == targets).float().mean()
    return loss, {"accuracy": accuracy}
