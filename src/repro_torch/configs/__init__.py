"""The paper's four LSTM-AE configurations (Section 4.1), one module each."""
