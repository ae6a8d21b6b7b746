"""PyTorch trainer backend (L4): the port of nnstreamer_tpu's
``trainer/optax_trainer.py``.

Registered as ``torch``, with the reference's names ``optax`` (its
default), ``jax`` and ``flax`` as aliases, so the reference's launch lines
run unchanged. The train step runs eagerly on the backend's device (the
card unless the element asks for the CPU); batches are assembled on the
host from pushed frames.

The ``model_config`` file is a python file defining, in torch:
  * ``init(generator, example_inputs) -> params`` — a tree (dicts, lists)
    of tensors; ``generator`` is a ``torch.Generator`` seeded with 0 on
    the backend's device, ``example_inputs`` the first batch's input
    tensors there;
  * ``loss_fn(params, inputs, labels) -> loss`` or ``(loss, metrics)``
    where metrics may hold "accuracy".
Custom options: ``batch:<N>,lr:<f>,optimizer:<adam|sgd|adamw>,
ckpt_dir:<dir>,ckpt_every:<epochs>``. The optimizers are optax's: Adam
(b1 0.9, b2 0.999, eps 1e-8 outside the square root), plain SGD (no
momentum) and AdamW with weight decay 1e-4 (optax's default; torch's is
1e-2). ``ckpt_dir`` enables full training-state checkpoints (params +
optimizer state + epoch + histories, trainer/checkpoint.py) with
automatic resume from the latest step. ``model_save_path`` is written and
``model_load_path`` read in flax's msgpack params format
(trainer/msgpack_params.py), so the reference's saved models load here.
"""
from __future__ import annotations

import os
import queue as _queue
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..utils.hw_accel import device_for_accelerator
from ..utils.log import logger
from ..utils.tree import tree_leaves, tree_map
from . import msgpack_params
from .base import TrainerBackend, TrainerProperties, register_trainer


_OPTIMIZERS = {
    "adam": lambda ps, lr: torch.optim.Adam(ps, lr=lr, betas=(0.9, 0.999),
                                            eps=1e-8),
    "sgd": lambda ps, lr: torch.optim.SGD(ps, lr=lr),
    "adamw": lambda ps, lr: torch.optim.AdamW(ps, lr=lr, betas=(0.9, 0.999),
                                              eps=1e-8, weight_decay=1e-4),
}


@register_trainer
class TorchTrainer(TrainerBackend):
    NAME = "torch"
    ALIASES = ("optax", "jax", "flax")

    def __init__(self):
        super().__init__()
        self._q: _queue.Queue = _queue.Queue(maxsize=1024)
        self._thread: Optional[threading.Thread] = None
        self._complete = threading.Event()
        self._running = threading.Event()
        self.params = None
        self._opt = None
        self.losses: List[float] = []
        self.accuracies: List[float] = []
        self.last_saved_path: Optional[str] = None
        self._state_restored = False

    # -- config -------------------------------------------------------------
    def configure(self, props: TrainerProperties) -> None:
        super().configure(props)
        self.device = device_for_accelerator(props.accelerator)
        ns: Dict[str, Any] = {"__file__": props.model_config}
        with open(props.model_config) as fh:
            exec(compile(fh.read(), props.model_config, "exec"), ns)  # noqa: S102
        if "init" not in ns or "loss_fn" not in ns:
            raise ValueError(f"{props.model_config}: must define init() and loss_fn()")
        self._init_fn = ns["init"]
        self._loss_fn = ns["loss_fn"]
        opts = props.custom_dict()
        self.batch_size = int(opts.get("batch", 16))
        self._lr = float(opts.get("lr", 1e-3))
        self._opt_name = opts.get("optimizer", "adam")
        if self._opt_name not in _OPTIMIZERS:
            raise ValueError(f"unknown optimizer '{self._opt_name}' "
                             f"(have {sorted(_OPTIMIZERS)})")
        self._ckpt = None
        self._ckpt_every = max(int(opts.get("ckpt_every", 1)), 1)
        ckpt_dir = opts.get("ckpt_dir")
        if ckpt_dir:
            from .checkpoint import CheckpointManager

            self._ckpt = CheckpointManager(ckpt_dir)
            # restore progress meta eagerly so even a zero-data resumed run
            # (source already past its epochs) reports true progress; the
            # state restore stays lazy in _build
            latest = self._ckpt.latest_step()
            if latest is not None:
                meta = self._ckpt.read_meta(latest)
                self.stats.epoch_count = int(meta.get("epoch_count", 0))
                self.losses = list(meta.get("losses", []))
                self.accuracies = list(meta.get("accuracies", []))
                if self.losses:
                    self.stats.training_loss = self.losses[-1]
                if self.accuracies:
                    self.stats.training_accuracy = self.accuracies[-1]

    # -- training thread ----------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._running.set()
        self._complete.clear()
        self._thread = threading.Thread(target=self._train_loop,
                                        name="torch-trainer", daemon=True)
        self._thread.start()

    def push_data(self, inputs: Sequence[Any], labels: Sequence[Any]) -> None:
        item = ("data", [np.asarray(x) for x in inputs],
                [np.asarray(y) for y in labels])
        # bounded put that never deadlocks: once the training thread exits
        # (epoch target reached) the queue has no consumer — drop instead of
        # blocking the streaming thread forever
        while self._running.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return
            except _queue.Full:
                if self._thread is None or not self._thread.is_alive():
                    return

    def end_of_data(self) -> None:
        try:
            self._q.put_nowait(("end", None, None))
        except _queue.Full:
            pass  # thread already finished its epochs; _complete is/will be set

    def wait_complete(self, timeout: float = 60.0) -> bool:
        return self._complete.wait(timeout)

    def stop(self) -> None:
        self._running.clear()
        # drain so the sentinel always fits and a dead consumer can't block us
        while True:
            try:
                self._q.get_nowait()
            except _queue.Empty:
                break
        try:
            self._q.put_nowait(("stop", None, None))
        except _queue.Full:
            pass
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=10.0)
        self._thread = None

    # -- core ---------------------------------------------------------------
    def _to_device(self, arrays: List[np.ndarray]) -> List[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def _build(self, example_inputs) -> None:
        gen = torch.Generator(device=self.device).manual_seed(0)
        params = self._init_fn(gen, example_inputs)
        params = tree_map(lambda p: p.detach().to(self.device), params)
        if self.props.model_load_path and os.path.exists(self.props.model_load_path):
            params = self._load(self.props.model_load_path, params)
        self.params = tree_map(lambda p: p.requires_grad_(True), params)
        self._opt = _OPTIMIZERS[self._opt_name](tree_leaves(self.params), self._lr)
        if self._ckpt is not None and self._ckpt.latest_step() is not None:
            self._resume_from_checkpoint()

    def _split(self, out):
        if isinstance(out, tuple):
            return out[0], out[1]
        return out, {}

    def _train_step(self, inputs, labels):
        loss, metrics = self._split(self._loss_fn(self.params, inputs, labels))
        self._opt.zero_grad(set_to_none=True)
        loss.backward()
        self._opt.step()
        return loss.detach(), {k: v.detach() if isinstance(v, torch.Tensor)
                               else v for k, v in metrics.items()}

    def _eval_step(self, inputs, labels):
        with torch.no_grad():
            return self._split(self._loss_fn(self.params, inputs, labels))

    def _train_loop(self) -> None:
        try:
            self._run_epochs()
        except Exception:  # noqa: BLE001 - surfaced via logger; element watches stats
            logger.exception("trainer thread failed")
        finally:
            self._complete.set()

    def _run_epochs(self) -> None:
        props = self.props
        per_epoch = props.num_training_samples or None
        # reference epoch layout (gsttensor_trainer.c): each epoch is
        # num-training-samples TRAIN frames followed by
        # num-validation-samples VALIDATION frames (evaluated, no update)
        val_per_epoch = props.num_validation_samples
        if val_per_epoch and not per_epoch:
            # without an epoch size there is no train/validation boundary;
            # silently training on the "held-out" frames would report a
            # fictitious validation score
            raise ValueError(
                "num-validation-samples requires num-training-samples to "
                "delimit the epoch's train/validation split")
        batch_in: List[List[np.ndarray]] = []
        batch_lb: List[List[np.ndarray]] = []
        seen = 0
        epoch_losses: List[float] = []
        epoch_accs: List[float] = []
        val_losses: List[float] = []
        val_accs: List[float] = []
        ended = False

        def flush_batch():
            nonlocal batch_in, batch_lb
            if not batch_in:
                return
            inputs = self._to_device([np.stack([b[i] for b in batch_in])
                                      for i in range(len(batch_in[0]))])
            labels = self._to_device([np.stack([b[i] for b in batch_lb])
                                      for i in range(len(batch_lb[0]))])
            if self.params is None:
                self._build(inputs)
            loss, metrics = self._train_step(inputs, labels)
            epoch_losses.append(float(loss))
            if "accuracy" in metrics:
                epoch_accs.append(float(metrics["accuracy"]))
            batch_in, batch_lb = [], []

        def eval_sample(inputs, labels):
            if self.params is None:
                return  # no training step ran yet: nothing to evaluate
            loss, metrics = self._eval_step(
                self._to_device([np.stack([x]) for x in inputs]),
                self._to_device([np.stack([y]) for y in labels]))
            val_losses.append(float(loss))
            if "accuracy" in metrics:
                val_accs.append(float(metrics["accuracy"]))

        def end_epoch():
            nonlocal epoch_losses, epoch_accs, val_losses, val_accs, seen
            flush_batch()
            if epoch_losses:
                self.stats.training_loss = float(np.mean(epoch_losses))
                self.losses.append(self.stats.training_loss)
            if epoch_accs:
                self.stats.training_accuracy = float(np.mean(epoch_accs))
                self.accuracies.append(self.stats.training_accuracy)
            if val_losses:
                self.stats.validation_loss = float(np.mean(val_losses))
            if val_accs:
                self.stats.validation_accuracy = float(np.mean(val_accs))
            self.stats.epoch_count += 1
            epoch_losses, epoch_accs, seen = [], [], 0
            val_losses, val_accs = [], []
            if self.stats.epoch_count % self._ckpt_every == 0:
                self.save_checkpoint()  # no-op without ckpt_dir/params

        while self._running.is_set():
            kind, inputs, labels = self._q.get()
            if kind == "stop":
                return
            if kind == "end":
                ended = True
                break
            seen += 1
            if per_epoch and val_per_epoch and seen > per_epoch:
                # validation tail of the epoch: evaluate, never update
                flush_batch()
                eval_sample(inputs, labels)
            else:
                batch_in.append(inputs)
                batch_lb.append(labels)
                if len(batch_in) >= self.batch_size:
                    flush_batch()
            if per_epoch and seen >= per_epoch + val_per_epoch:
                end_epoch()
                if self.stats.epoch_count >= props.epochs:
                    break
        if ended and (seen or epoch_losses or batch_in):
            end_epoch()
        if props.model_save_path and self.params is not None:
            self.save(props.model_save_path)

    # -- checkpointing ------------------------------------------------------
    def save_checkpoint(self) -> Optional[str]:
        """Full training state → ckpt_dir/step_<epoch> (params, optimizer
        state, epoch counter, loss/accuracy history, data-iterator epoch)."""
        if self._ckpt is None or self.params is None:
            return None
        meta = {
            "epoch_count": self.stats.epoch_count,
            "losses": self.losses,
            "accuracies": self.accuracies,
            # datareposrc resumes with start-epoch=<data_epoch> (same seed
            # → identical shuffle stream continuation)
            "data_epoch": self.stats.epoch_count,
        }
        params = tree_map(lambda p: p.detach(), self.params)
        return self._ckpt.save(
            self.stats.epoch_count,
            {"params": params, "opt_state": self._opt.state_dict()}, meta)

    def _resume_from_checkpoint(self) -> None:
        state, meta = self._ckpt.restore(map_location=self.device)
        with torch.no_grad():
            for p, q in zip(tree_leaves(self.params), tree_leaves(state["params"])):
                p.copy_(q)
        self._opt.load_state_dict(state["opt_state"])
        self.stats.epoch_count = int(meta.get("epoch_count", 0))
        self.losses = list(meta.get("losses", []))
        self.accuracies = list(meta.get("accuracies", []))
        self._state_restored = True
        logger.info("trainer resumed at epoch %d from %s",
                    self.stats.epoch_count, self._ckpt.directory)

    def save(self, path: Optional[str] = None) -> Optional[str]:
        path = path or (self.props.model_save_path if self.props else None)
        if not path or self.params is None:
            return None
        with open(path, "wb") as fh:
            fh.write(msgpack_params.dumps(self.params))
        self.last_saved_path = path
        logger.info("trainer saved model to %s", path)
        return path

    def _load(self, path: str, target):
        with open(path, "rb") as fh:
            params = msgpack_params.restore(target,
                                            msgpack_params.loads(fh.read()))
        logger.info("trainer resumed from %s", path)
        return params
