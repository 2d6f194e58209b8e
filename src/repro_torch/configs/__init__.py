"""The paper's four LSTM-AE configurations (Section 4.1), the
transformer LMs, dense and MoE, and the RWKV-6 LM, one module each."""
