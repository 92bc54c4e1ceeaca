"""Training core of the port: AdamW matching optax, the single-device
trainer, the loop over in-memory batches, metric meters and step
checkpoints."""
