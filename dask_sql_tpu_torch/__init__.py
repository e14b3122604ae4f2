"""dask_sql_tpu_torch: the SQL engine of ``dask_sql_tpu`` ported to PyTorch
and CUDA.

The same front end and planner (copied from the JAX package), columnar
tables on torch tensors, an eager executor, and hand-written CUDA kernels
for Hopper where the JAX package has Pallas kernels for the TPU
(``csrc/``, bound in ``ops/gpu_kernels.py``); the serving path in front
of them (admission, the result cache, the Presto-wire server ``run_server``
and the REPL ``cmd_loop``).  It imports neither JAX nor ``dask_sql_tpu``.
"""
from .cmd import cmd_loop
from .context import Context
from .server.app import run_server
from .table import Column, Table

__all__ = ["Context", "Column", "Table", "cmd_loop", "run_server"]
