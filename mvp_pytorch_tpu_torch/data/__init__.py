"""The data plane of the port: tokenizer, TSV feature store, tensorization,
the retrieval dataset, synthetic roots and the process loader. Host code;
nothing here imports JAX or the JAX package."""
