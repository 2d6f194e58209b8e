"""The paper's four LSTM-AE configurations (Section 4.1), the
transformer LMs, dense and MoE, the RWKV-6 LM and the Jamba hybrid, one
module each."""
