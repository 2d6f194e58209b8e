"""The paper's four LSTM-AE configurations (Section 4.1) and the dense
transformer LMs, one module each."""
