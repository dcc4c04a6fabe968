"""Operators: the log-mel frontend and attention, each with its CUDA kernel."""
