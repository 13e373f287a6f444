from setuptools import find_packages, setup

setup(
    name="lightgbm_tpu",
    version="0.1.0",
    description="TPU-native gradient boosting framework (LightGBM-compatible API)",
    packages=find_packages(include=["lightgbm_tpu", "lightgbm_tpu.*",
                                    "lightgbm_tpu_torch",
                                    "lightgbm_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its Hopper kernels from these sources
    # with nvcc at first use
    package_data={"lightgbm_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    extras_require={"torch": ["torch"]},
)
