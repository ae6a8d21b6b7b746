"""Trainer backend vtable (L2).

The port of nnstreamer_tpu's ``trainer/base.py``. Reference analog:
``GstTensorTrainerFramework`` + ``GstTensorTrainerProperties``
(gst/nnstreamer/include/nnstreamer_plugin_api_trainer.h:30-55 —
model_config, save/load path, num_training/validation_samples, epochs;
outputs epoch_count, losses, accuracies; push-data + a framework-owned
training thread). The port's properties add ``accelerator``, the device
the element asks for (``cuda:0`` unless ``cpu``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

from ..registry.subplugin import SubpluginKind, register


@dataclass
class TrainerProperties:
    model_config: str = ""              # path to the model-definition file
    model_save_path: str = ""
    model_load_path: str = ""           # resume checkpoint
    num_inputs: int = 1                 # tensors per frame that are inputs
    num_labels: int = 1                 # tensors per frame that are labels
    num_training_samples: int = 0       # samples per epoch
    num_validation_samples: int = 0
    epochs: int = 1
    custom: str = ""                    # "batch:32,lr:0.001,optimizer:adam"
    accelerator: str = "auto"           # auto | gpu | cuda | cuda:N | cpu

    def custom_dict(self) -> Dict[str, str]:
        out: Dict[str, str] = {}
        for part in self.custom.split(","):
            part = part.strip()
            if part:
                k, _, v = part.partition(":")
                out[k.strip()] = v.strip()
        return out


@dataclass
class TrainerStats:
    """Live training telemetry (reference props
    nnstreamer_plugin_api_trainer.h:46-54)."""

    epoch_count: int = 0
    training_loss: float = 0.0
    validation_loss: float = 0.0
    training_accuracy: float = 0.0
    validation_accuracy: float = 0.0


class TrainerBackend:
    """One instance = one training session. Lifecycle: ``configure`` →
    ``start`` → ``push_data``×N → (epochs complete) → ``save`` → ``stop``."""

    NAME = ""

    def __init__(self):
        self.props: Optional[TrainerProperties] = None
        self.stats = TrainerStats()

    def configure(self, props: TrainerProperties) -> None:
        self.props = props

    def start(self) -> None:
        """Spawn the training thread (reference: subplugin-owned thread)."""

    def push_data(self, inputs: Sequence[Any], labels: Sequence[Any]) -> None:
        raise NotImplementedError

    def end_of_data(self) -> None:
        """No more samples will arrive; finish current epoch work."""

    def wait_complete(self, timeout: float = 60.0) -> bool:
        """Block until the target epochs are trained."""
        raise NotImplementedError

    def save(self, path: Optional[str] = None) -> Optional[str]:
        raise NotImplementedError

    def stop(self) -> None:
        """Tear down (training thread join)."""


def register_trainer(cls):
    register(SubpluginKind.TRAINER, cls.NAME, cls,
             aliases=getattr(cls, "ALIASES", ()))
    return cls
