"""Quantization core of the port: configs, the integer codec, the policy."""
