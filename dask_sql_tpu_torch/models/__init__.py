"""SQL-driven machine learning: CREATE MODEL / EXPERIMENT, EXPORT MODEL
(``training.py``), out-of-core training and batched prediction
(``incremental.py``).  The estimators run on the host; their training
queries and ``PREDICT``'s input and output run on the context's device."""
