"""Training of the port: the train step (autograd + AdamW) and its state."""
from repro_torch.training.step import TrainState, build_train_step, init_train_state

__all__ = ["TrainState", "build_train_step", "init_train_state"]
