"""Unrolled multi-time-step LIF kernel (+ fused IAND epilogue)."""
