from repro_torch.models.api import ModelAPI, build_model
from repro_torch.models.lstm_ae import decode_step, init_stream_state, prefill, train_loss

__all__ = ["ModelAPI", "build_model", "decode_step", "init_stream_state", "prefill",
           "train_loss"]
