"""Model definitions of the port beyond the vision Spikformer: the
architecture config, the LM registry, loss and steps, the generic decoder of
the assigned families (transformer, layers, moe, mamba2, rglru,
quantization) and the spiking LM."""
