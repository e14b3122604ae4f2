"""dask_sql_tpu_torch: the SQL engine of ``dask_sql_tpu`` ported to PyTorch
and CUDA.

The same front end and planner (copied from the JAX package), columnar
tables on torch tensors, an eager executor, and hand-written CUDA kernels
for Hopper where the JAX package has Pallas kernels for the TPU
(``csrc/``, bound in ``ops/gpu_kernels.py``).  It imports neither JAX nor
``dask_sql_tpu``.
"""
from .context import Context
from .table import Column, Table

__all__ = ["Context", "Column", "Table"]
