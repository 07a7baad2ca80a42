"""Package build for mpibwa-tpu.

Python + JAX for the device path; the native host runtime (C: finalization,
fixmate, SA-IS index builder) ships as source in mpibwa_tpu/native/ and is
compiled on demand by native/__init__.py with the system compiler (no
compiler at runtime -> exact Python fallbacks).
"""

from setuptools import find_packages, setup

setup(
    name="mpibwa-tpu",
    version="0.1.0",
    description="TPU-native BWA-MEM-class read aligner (JAX/XLA/Pallas)",
    packages=find_packages(include=["mpibwa_tpu", "mpibwa_tpu.*",
                                    "mpibwa_tpu_torch", "mpibwa_tpu_torch.*"]),
    # the port's CUDA sources build with nvcc on first use
    # (mpibwa_tpu_torch/ops/_build.py), its C runtime with the system
    # compiler (mpibwa_tpu_torch/native/__init__.py)
    package_data={"mpibwa_tpu.native": ["*.c"],
                  "mpibwa_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
                  "mpibwa_tpu_torch.native": ["*.c", "*.h"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    entry_points={
        "console_scripts": [
            "mpibwa-tpu=mpibwa_tpu.cli:main",
        ]
    },
)
