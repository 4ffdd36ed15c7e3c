"""Optimizers, batched over solver lanes: one lane per random-effect
entity, or a single lane for a fixed effect."""
