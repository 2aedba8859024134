"""Fused LSTM cell kernel: ``ops.lstm_seq`` (wrapper), ``kernel`` (CUDA
build and binding), ``ref`` (plain PyTorch version)."""
