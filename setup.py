"""Install glass_tpu (reference ships an equivalent setup.py for its package).

The runtime dependencies (jax, flax, optax, orbax-checkpoint, numpy,
opencv-python, pyyaml) are deliberately not pinned here: on TPU hosts jax
must match the libtpu/plugin build already on the machine, so the package
installs against whatever compatible jax toolchain the environment provides.
"""

import setuptools

setuptools.setup(
    name="glass-tpu",
    version="0.3",
    description="TPU-native end-to-end scene-text spotting (GLASS capability surface)",
    long_description=open("README.md").read(),
    long_description_content_type="text/markdown",
    license="Apache License 2.0",
    packages=setuptools.find_packages(
        include=["glass_tpu", "glass_tpu.*", "glass_tpu_torch", "glass_tpu_torch.*"]
    ),
    include_package_data=True,
    # the C++ polygon-clipping source ships with the package and is built
    # on first use (glass_tpu/native/build.py); so do the port's CUDA
    # kernel sources (glass_tpu_torch/ops/_cuda.py)
    package_data={
        "glass_tpu.native": ["*.cpp"],
        "glass_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
    },
    python_requires=">=3.9",
    classifiers=[
        "Programming Language :: Python :: 3",
        "License :: OSI Approved :: Apache Software License",
        "Operating System :: OS Independent",
    ],
)
