"""tensor_trainer: in-pipeline training element (L3).

The port of nnstreamer_tpu's ``elements/trainer.py``. Reference analog:
``gst/nnstreamer/elements/gsttensor_trainer.c`` (call stack SURVEY.md
§3.5) — receives (input, label) tensor frames, feeds the trainer
subplugin's queue, exposes epoch/loss/accuracy, posts a bus message when
training completes. Like ``tensor_generate`` it trains on ``cuda:0``
unless given ``accelerator=cpu``.
"""
from __future__ import annotations

from typing import Optional

from ..core import Buffer, Caps, MessageType
from ..registry.elements import register_element
from ..registry.subplugin import SubpluginKind, get as get_subplugin
from ..runtime.element import ElementError, Prop, SinkElement, prop_bool
from ..runtime.pad import PadDirection, PadTemplate
from ..trainer.base import TrainerBackend, TrainerProperties


@register_element
class TensorTrainer(SinkElement):
    ELEMENT_NAME = "tensor_trainer"
    SINK_TEMPLATES = (PadTemplate("sink", PadDirection.SINK, Caps.new("other/tensors")),)
    PROPERTIES = {
        "framework": Prop("optax", str, "trainer backend name (optax, jax "
                          "and flax are the torch trainer)"),
        "model_config": Prop("", str, "model definition file"),
        "model_save_path": Prop("", str),
        "model_load_path": Prop("", str, "resume checkpoint"),
        "num_inputs": Prop(1, int, "leading tensors per frame used as inputs"),
        "num_labels": Prop(1, int, "trailing tensors per frame used as labels"),
        "num_training_samples": Prop(0, int, "samples per epoch (0 = one epoch of all data)"),
        "num_validation_samples": Prop(0, int,
                                       "samples held out for validation "
                                       "(reference gsttensor_trainer.c:229)"),
        "epochs": Prop(1, int),
        "custom": Prop("", str, "backend options 'batch:32,lr:0.001'"),
        # reference :248: write-only one-way switch — complete (stop+save)
        # after the current epoch
        "ready_to_complete": Prop(False, prop_bool,
                                  "set mid-run to finish training after "
                                  "the current epoch (cannot be reverted)"),
        "accelerator": Prop("auto", str,
                            "auto | gpu | cuda | cuda:N | cpu (auto, gpu "
                            "and cuda train on cuda:0)"),
    }

    def set_property(self, key: str, value) -> None:
        super().set_property(key, value)
        # construct-time sets run before __init__ defines self.backend;
        # the switch only acts on a live backend (mid-run toggle)
        backend = getattr(self, "backend", None)
        if (key.replace("-", "_") == "ready_to_complete"
                and self.props["ready_to_complete"]
                and backend is not None):
            backend.end_of_data()  # finish with the data it has

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.backend: Optional[TrainerBackend] = None
        self._pushed = 0

    def start(self) -> None:
        cls = get_subplugin(SubpluginKind.TRAINER, self.props["framework"])
        self.backend = cls()
        self.backend.configure(TrainerProperties(
            model_config=self.props["model_config"],
            model_save_path=self.props["model_save_path"],
            model_load_path=self.props["model_load_path"],
            num_inputs=self.props["num_inputs"],
            num_labels=self.props["num_labels"],
            num_training_samples=self.props["num_training_samples"],
            num_validation_samples=self.props["num_validation_samples"],
            epochs=self.props["epochs"],
            custom=self.props["custom"],
            accelerator=self.props["accelerator"],
        ))
        self.backend.start()

    def render(self, buf: Buffer) -> None:
        n_in = self.props["num_inputs"]
        n_lb = self.props["num_labels"]
        if buf.num_tensors != n_in + n_lb:
            raise ElementError(
                f"{self.describe()}: frame has {buf.num_tensors} tensors, "
                f"expected {n_in} inputs + {n_lb} labels"
            )
        arrays = buf.as_numpy().tensors
        self.backend.push_data(arrays[:n_in], arrays[n_in:])
        self._pushed += 1

    PROPERTIES_EOS_TIMEOUT_S = 120.0

    def handle_eos(self) -> None:
        if self.backend is not None:
            self.backend.end_of_data()
            done = self.backend.wait_complete(timeout=self.PROPERTIES_EOS_TIMEOUT_S)
            s = self.backend.stats
            # report the path the backend actually wrote, not the requested
            # one — a zero-batch run (e.g. fully-resumed) saves nothing
            saved = getattr(self.backend, "last_saved_path",
                            self.props["model_save_path"] or None)
            self.post_message(
                MessageType.ELEMENT,
                event="training-complete" if done else "training-timeout",
                epochs=s.epoch_count,
                training_loss=s.training_loss,
                training_accuracy=s.training_accuracy,
                validation_loss=s.validation_loss,
                validation_accuracy=s.validation_accuracy,
                model_saved=saved if done else None,
                samples=self._pushed,
            )
        super().handle_eos()

    def stop(self) -> None:
        if self.backend is not None:
            self.backend.stop()
            self.backend = None
