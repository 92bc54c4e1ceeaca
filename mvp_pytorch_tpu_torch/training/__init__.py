"""Training core of the port: AdamW matching optax, the single-device
trainer, metric meters and step checkpoints."""
