"""Packaging for dask_sql_tpu (reference: /root/reference/setup.py console
scripts at :106-111; no jar build step — the planner is native Python/C++)."""
from setuptools import find_packages, setup
from setuptools.dist import Distribution


class _BinaryDistribution(Distribution):
    """The prebuilt native parser makes this a platform wheel."""

    def has_ext_modules(self):
        return True


setup(
    name="dask_sql_tpu",
    version="0.1.0",
    description="TPU-native distributed SQL query engine (dask-sql capability parity)",
    packages=find_packages(include=["dask_sql_tpu", "dask_sql_tpu.*",
                                    "dask_sql_tpu_torch",
                                    "dask_sql_tpu_torch.*"]),
    package_data={"dask_sql_tpu.native": ["*.so"],
                  "dask_sql_tpu_torch": ["csrc/*.cu", "native/*.cpp",
                                         "native/*.h"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "numpy",
        "pandas",
    ],
    extras_require={
        "dev": ["pytest"],
        "ml": ["scikit-learn", "joblib"],
        "cli": ["prompt_toolkit", "pygments"],
        # the PyTorch/CUDA port (dask_sql_tpu_torch); its kernels build
        # with nvcc from csrc/, and its parser with g++ from native/, at
        # first use
        "torch": ["torch"],
    },
    entry_points={
        "console_scripts": [
            "dask-sql-tpu = dask_sql_tpu.cmd:main",
            "dask-sql-tpu-server = dask_sql_tpu.server.app:main",
            "dask-sql-tpu-torch = dask_sql_tpu_torch.cmd:main",
            "dask-sql-tpu-torch-server = dask_sql_tpu_torch.server.app:main",
        ]
    },
    distclass=_BinaryDistribution,
)
