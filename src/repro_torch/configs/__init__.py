"""The paper's four LSTM-AE configurations (Section 4.1), the
transformer LMs, dense and MoE, the RWKV-6 LM, the Jamba hybrid and the
Whisper encoder-decoder, one module each: every architecture of the
reference's registry."""
