"""Table sources beyond the resident dict / frame inputs of
``Context.create_table``: ``chunked.ChunkedSource``, the host-resident
batches of an out-of-device-memory table."""
