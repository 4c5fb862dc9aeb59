"""Tick-batched softmax-free spiking self-attention kernel."""
