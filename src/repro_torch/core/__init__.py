"""Core spiking-transformer library (PyTorch): LIF neurons, IAND residual,
spiking self-attention, bit-packed spike trains, the spiking tokenizer and
the Spikformer model."""
