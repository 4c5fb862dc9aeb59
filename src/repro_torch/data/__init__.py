"""Deterministic synthetic data (numpy): the images the training examples fit."""
