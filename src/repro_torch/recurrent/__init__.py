"""Recurrent cells (LSTM/GRU) as state-space systems, and their block."""
