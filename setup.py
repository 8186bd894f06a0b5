"""Package metadata + C-extension-free install (native parts build via
make; see native/Makefile)."""

from setuptools import find_packages, setup

setup(
    name="k8s-tpu",
    version="0.1.0",
    description=(
        "TPU-native distributed training job framework: TpuJob CRD + "
        "operator control plane, JAX/XLA SPMD data plane"
    ),
    packages=find_packages(include=[
        "k8s_tpu", "k8s_tpu.*", "k8s_tpu_torch", "k8s_tpu_torch.*"]),
    # the PyTorch/CUDA port builds its kernels from these at first use
    package_data={"k8s_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "pyyaml"],
    extras_require={
        "jax": ["jax", "flax", "optax", "orbax-checkpoint", "chex"],
        # the PyTorch/CUDA port (k8s_tpu_torch); nvcc builds its kernels
        "torch": ["torch"],
        # TB scalar event writing from MetricLogger (best-effort aux;
        # absent → stdout JSONL only)
        "tensorboard": ["torch"],
        # HF pretrained-weight import (tools/hf_import.py)
        "hf": ["torch", "transformers"],
    },
    entry_points={
        "console_scripts": [
            "tpu-operator=k8s_tpu.operator:main",
            "ktpu=k8s_tpu.tools.kubectl_local:main",
            "ktpu-e2e=k8s_tpu.tools.e2e:main",
            "ktpu-test-runner=k8s_tpu.tools.test_runner:main",
        ]
    },
)
