"""Tasks of the port: retrieval training, two-stage retrieval scoring and
its rank algebra, and pretraining."""
