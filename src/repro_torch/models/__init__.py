"""Model stack of the port: so far the paged KV cache (`paged_kv`) and the
attention primitives it is checked against (`layers`)."""
