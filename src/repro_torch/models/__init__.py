"""Model definitions of the port beyond the vision Spikformer: the
architecture config, the LM registry and the spiking LM."""
