from repro_torch.models.lstm_ae import decode_step, init_stream_state, prefill, train_loss

__all__ = ["decode_step", "init_stream_state", "prefill", "train_loss"]
