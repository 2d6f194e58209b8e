"""The paper's four LSTM-AE configurations (Section 4.1) and the
transformer LMs, dense and MoE, one module each."""
