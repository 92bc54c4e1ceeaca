"""Tasks of the port: two-stage retrieval scoring and its rank algebra."""
