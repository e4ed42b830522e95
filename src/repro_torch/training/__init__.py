"""Training loop substrate of the port."""

from .train_step import TrainConfig, TrainState, make_train_step, train_state_init  # noqa: F401
