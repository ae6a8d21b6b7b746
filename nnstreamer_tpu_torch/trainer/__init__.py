"""Training backends for ``tensor_trainer``: the backend vtable
(`base.py`), training-state checkpoints (`checkpoint.py`), the flax
msgpack params format (`msgpack_params.py`) and the PyTorch trainer
(`torch_trainer.py`, registered as ``torch`` with the reference's names
``optax``, ``jax`` and ``flax``)."""
