"""Published peaks of the card (NVIDIA H100 SXM data sheet, at its 700 W
limit): the denominators of every roofline share the benchmark reports."""

HBM_BYTES_PER_S = 3.35e12
