"""Core spiking-transformer library (PyTorch): LIF neurons, IAND residual,
spiking self-attention, the spiking tokenizer and the Spikformer model."""
